"""Device idle milliseconds a denoise step inside the DiT: the window
traced on host and device, where nothing ran on the device while the
host was inside one of the program's spans ``more4d.dit.*`` (embed,
backbone, finalize), over the steps the window completed."""

from h100_bench.yardstick import spans


def read(ctx):
    ns = spans.idle_ns(ctx.trace, spans.DIT)
    if ns is None or not ctx.trace_units:
        return None
    return ns / 1e6 / ctx.trace_units
