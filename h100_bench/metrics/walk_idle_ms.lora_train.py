"""Device idle milliseconds a LoRA step inside its two walks: the window
traced on host and device, where nothing ran on the device while the
host was inside the program's span ``more4d.lora.forward_walk`` or
``more4d.lora.backward_walk``, over the steps the window completed. The
exposed block copies and the host's launch gaps together."""

from h100_bench.yardstick import lora, spans


def read(ctx):
    ns = spans.idle_ns(ctx.trace, lora.WALKS)
    if ns is None or not ctx.trace_units:
        return None
    return ns / 1e6 / ctx.trace_units
