"""The share of the window traced on the device alone (its first device
activity to its last; no host tracing to slow the launches) in which
nothing ran on the device (no kernel, copy or set; overlapping ones
counted once), in the denoise cell."""

from h100_bench.yardstick.trace import busy_ns


def read(ctx):
    lo, hi = ctx.device_trace.window()
    if hi <= lo or not ctx.device_trace.in_window():
        return None
    return 100.0 * (1.0 - busy_ns(ctx.device_trace) / (hi - lo))
