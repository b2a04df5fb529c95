"""Kernels a train step launches in the update: the device kernels (not
copies or sets) whose launch call ran inside the program's span
``more4d.train.clamp``, ``more4d.train.optimizer`` or
``more4d.train.ema``, in the window traced on host and device, over the
steps the window completed."""

from h100_bench.yardstick import spans


def read(ctx):
    acts = spans.launched(ctx.trace, spans.UPDATE)
    if acts is None or not ctx.trace_units:
        return None
    return sum(a.kernel for a in acts) / ctx.trace_units
