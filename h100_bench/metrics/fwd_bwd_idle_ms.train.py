"""Device idle milliseconds a train step in the forward and backward: the
window traced on host and device, where nothing ran on the device while
the host was inside the program's span ``more4d.train.forward`` (the DiT
and the loss) or ``more4d.train.backward`` (``loss.backward()``, the
remat recompute included), over the steps the window completed."""

from h100_bench.yardstick import spans


def read(ctx):
    ns = spans.idle_ns(ctx.trace, spans.FWD_BWD)
    if ns is None or not ctx.trace_units:
        return None
    return ns / 1e6 / ctx.trace_units
