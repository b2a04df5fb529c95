"""The storage of the 14B streamed from pinned host memory
(``--offload_blocks``), in plain code, and the reference's weights in it.

The streamed configuration keeps the parts outside the blocks (the
embeddings, the head, their norms) on the card in bf16, and stores each
block in host memory: fp8 (float8_e4m3fn, no scale, rounded to nearest
even from bf16) for every Linear's weight matrix of the block, bf16 for
everything else of the block: its biases, the qk and ``norm3`` norms, the
modulation table and the FiLM gates. A block bias is bf16 here where the
resident fp8 configuration (``fp8.stored_in_fp8``) stores it in fp8, and
the matrices outside the blocks are bf16 here where it stores them in fp8.
"""

from __future__ import annotations

import torch

from h100_bench import inputs
from h100_bench.reference.fp8 import round_e4m3


def stored_streamed(name: str) -> bool:
    """Whether the streamed configuration stores the DiT tensor ``name``
    (the released checkpoint's name) in fp8: a block's Linear weight
    matrices, and nothing else."""
    if not name.startswith("blocks."):
        return False
    rest = name.split(".", 2)[2]
    module, _, leaf = rest.rpartition(".")
    return leaf == "weight" and "norm" not in module


def weights(cfg, seed: int, device):
    """The reference's fp32 weights in the streamed storage, made again
    from the seed a group at a time: bf16, and fp8 where
    ``stored_streamed`` says so."""
    def stored(name, v):
        v = v.float()
        return round_e4m3(v) if stored_streamed(name) else v
    return inputs.group_maker(cfg, seed, torch.bfloat16, device, stored)[0]
