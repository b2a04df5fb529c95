"""Device milliseconds a denoise step in which a block's copy host ->
card ran and no kernel ran: the union of the copies launched inside the
program's span ``more4d.stream.fetch`` (within the walk's
``more4d.dit.backbone``) less the union of every kernel, in the window
traced on host and device, over the steps the window completed. The copy
on the critical path."""

from h100_bench.yardstick import stream
from h100_bench.yardstick.trace import union_ns


def read(ctx):
    acts = stream.fetched(ctx.trace)
    if not acts or not ctx.trace_units:
        return None
    window = ctx.trace.window()
    kernels = [(a.start, a.end)
               for a in ctx.trace.in_window(kernels_only=True)]
    # |copies less kernels| = |copies or kernels| - |kernels|
    ns = union_ns([(a.start, a.end) for a in acts] + kernels, window) \
        - union_ns(kernels, window)
    return ns / 1e6 / ctx.trace_units
