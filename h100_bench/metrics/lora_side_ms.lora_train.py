"""Device milliseconds a step of the kernels launched inside the
program's span ``more4d.lora.side``: the LoRA side path's forward work
(its casts, its two products and its add) on every factored Linear, in
the forward walk and in the backward walk's recompute, in the window
traced on host and device, over the steps the window completed. The
side path's backward is launched by the autograd engine outside the
span and is not counted."""

from h100_bench.yardstick import lora, spans


def read(ctx):
    acts = spans.launched(ctx.trace, lora.SIDE)
    kernels = [a for a in acts or () if a.kernel]
    if not kernels or not ctx.trace_units:
        return None
    return sum(a.end - a.start for a in kernels) / 1e6 / ctx.trace_units
