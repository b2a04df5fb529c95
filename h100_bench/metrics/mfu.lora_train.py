"""The streamed LoRA step's share of the card's bf16 peak: the frozen
count of a step's work at batch 1 (``yardstick/lora.py step_flops``: the
forward, the backward's dx through the frozen Linears and the attention
backward, the side path both ways; not the backward walk's recompute)
times the steps completed, over the window (in a traced run the untraced
one: the profiler slows the host). ``mfu.train``'s 3 x the forward would
count weight gradients this step never computes."""

from h100_bench.yardstick.counts import BF16_FLOPS
from h100_bench.yardstick.lora import step_flops


def read(ctx):
    if not ctx.units:
        return None
    return 100.0 * step_flops(ctx.cfg) * ctx.units / (ctx.window_s
                                                      * BF16_FLOPS)
