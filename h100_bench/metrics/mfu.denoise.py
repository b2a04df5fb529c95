"""The whole denoise step's share of the card's bf16 peak: the frozen
forward count at the configuration's tokens, times 2 (the CFG-doubled
batch), times the steps completed, over the window (in a traced run the
untraced one: the profiler slows the host). The 14B's fp8 weights are
widened to bf16 before each product, so its peak is bf16 too."""

from h100_bench.yardstick.counts import (BF16_FLOPS, dit_forward_flops,
                                         num_tokens)


def read(ctx):
    if not ctx.units:
        return None
    flops = dit_forward_flops(ctx.cfg, num_tokens(ctx.cfg), batch=2)
    return 100.0 * flops * ctx.units / (ctx.window_s * BF16_FLOPS)
