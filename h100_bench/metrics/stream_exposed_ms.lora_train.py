"""Device milliseconds a LoRA step in which a block's copy host -> card
ran and no kernel ran: the union of the copies launched inside the
program's span ``more4d.stream.fetch`` within its two walks
(``more4d.lora.forward_walk``, ``.backward_walk``) less the union of
every kernel, in the window traced on host and device, over the steps
the window completed. The copies on the critical path, 80 a step."""

from h100_bench.yardstick import lora
from h100_bench.yardstick.trace import union_ns


def read(ctx):
    acts = lora.walk_copies(ctx.trace)
    if not acts or not ctx.trace_units:
        return None
    window = ctx.trace.window()
    kernels = [(a.start, a.end)
               for a in ctx.trace.in_window(kernels_only=True)]
    # |copies less kernels| = |copies or kernels| - |kernels|
    ns = union_ns([(a.start, a.end) for a in acts] + kernels, window) \
        - union_ns(kernels, window)
    return ns / 1e6 / ctx.trace_units
