"""Device idle milliseconds a denoise step in the sampler loop around the
DiT: the window traced on host and device, where nothing ran on the
device while the host was inside the program's span ``more4d.denoise``
(one request: its inputs' placement, the CFG combine, the scheduler's
steps) and outside every ``more4d.dit.*``, over the steps the window
completed."""

from h100_bench.yardstick import spans


def read(ctx):
    ns = spans.idle_ns(ctx.trace, spans.REQUEST, outside=spans.DIT)
    if ns is None or not ctx.trace_units:
        return None
    return ns / 1e6 / ctx.trace_units
