"""The streamed walk's copies against the card's host link: the bytes of
the block copies host -> card launched inside the program's span
``more4d.stream.fetch`` (one block's host buffer each,
``yardstick/stream.py block_bytes``) over their device time, as a share of
the link's one-way peak (PCIe Gen5 x16, 63.0 GB/s), in the window traced
on host and device. The copy's roofline: the one device operation the
streamed walk adds."""

from h100_bench.yardstick import stream


def read(ctx):
    acts = stream.fetched(ctx.trace)
    if not acts:
        return None
    device_s = sum(a.end - a.start for a in acts) / 1e9
    if device_s <= 0:
        return None
    nbytes = len(acts) * stream.block_bytes(ctx.cfg)
    return 100.0 * nbytes / device_s / stream.H2D_BYTES_PER_S
