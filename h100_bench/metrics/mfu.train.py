"""The whole train step's share of the card's bf16 peak: 3 x the frozen
forward count at batch 1 (forward and backward; the rematerialised
forward is not counted) times the steps completed, over the window (in a
traced run the untraced one: the profiler slows the host)."""

from h100_bench.yardstick.counts import (BF16_FLOPS, dit_forward_flops,
                                         num_tokens)


def read(ctx):
    if not ctx.units:
        return None
    flops = 3 * dit_forward_flops(ctx.cfg, num_tokens(ctx.cfg), batch=1)
    return 100.0 * flops * ctx.units / (ctx.window_s * BF16_FLOPS)
