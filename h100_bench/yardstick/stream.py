"""Frozen arithmetic of the streamed blocks: the card's host link, the
bytes of one block's copy, and the copies of a trace.

``block_bytes`` is a frozen copy of the port's host-block layout
(``parallel/offload.py _layout``): a block's tensors packed into one flat
buffer in their storage types (``reference/stream.py stored_streamed``),
each start aligned to 256 bytes. One copy host -> card moves one such
buffer whole.
"""

from __future__ import annotations

import math
from typing import List, Optional

from h100_bench import inputs
from h100_bench.reference.stream import stored_streamed
from h100_bench.yardstick import kinds
from h100_bench.yardstick.trace import Activity, Trace

# The H100 SXM's host link, PCIe Gen5 x16 (NVIDIA H100 data sheet; on the
# benchmark's machine `nvidia-smi -q` reads the link's generation and width
# as N/A): 32 GT/s a lane, 128b/130b encoding, 32e9 x 16 x 128 / 130 / 8
# bytes/s in one direction
H2D_BYTES_PER_S = 63.0e9
ALIGN = 256

FETCH = "more4d.stream.fetch"
BACKBONE = "more4d.dit.backbone"


def block_bytes(cfg) -> int:
    """Bytes of one block's host buffer, which one copy moves."""
    n = 0
    for name, shape, _, _ in inputs.block_spec(cfg):
        size = math.prod(shape) * (1 if stored_streamed("blocks.0." + name)
                                   else 2)
        n += -(-size // ALIGN) * ALIGN
    return n


def fetched(trace: Trace) -> Optional[List[Activity]]:
    """The host -> card copies in the window whose launch ran inside a
    ``more4d.stream.fetch`` span: the block copies of the streamed walk.
    None where the window holds no such span inside a block walk, or no
    such copy."""
    names = {s.name for s in trace.spans}
    if FETCH not in names or BACKBONE not in names:
        return None
    acts = [a for a in trace.attributed(FETCH)
            if kinds.kind(a.name) == kinds.HOST_COPIES]
    return acts or None

