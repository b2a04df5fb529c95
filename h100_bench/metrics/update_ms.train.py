"""Device milliseconds a train step in the update: every activity
(kernels, copies, sets) launched inside the program's spans
``more4d.train.clamp`` (the gradient clamp and the step's host reads),
``more4d.train.optimizer`` (``GradUpdate``: its norm, AdamW) and
``more4d.train.ema``, in the window traced on host and device, over the
steps the window completed."""

from h100_bench.yardstick import spans


def read(ctx):
    acts = spans.launched(ctx.trace, spans.UPDATE)
    if acts is None or not ctx.trace_units:
        return None
    lo, hi = ctx.trace.window()
    ns = sum(min(a.end, hi) - max(a.start, lo) for a in acts)
    return ns / 1e6 / ctx.trace_units
