"""Device milliseconds a train step in PyTorch's own elementwise,
reduction, cast and copy kernels (the eager model code: norms, RoPE, the
modulation, the fp8 widening), by the frozen table of kinds, in the
window traced on the device alone."""

from h100_bench.yardstick import kinds

KINDS = (kinds.ELEMENTWISE, kinds.COPIES, kinds.REDUCTIONS)


def read(ctx):
    if not ctx.device_units:
        return None
    lo, hi = ctx.device_trace.window()
    ns = sum(min(a.end, hi) - max(a.start, lo)
             for a in ctx.device_trace.in_window(kernels_only=True)
             if kinds.kind(a.name) in KINDS)
    # no such kernel in the window: nothing to read
    return ns / 1e6 / ctx.device_units if ns else None
