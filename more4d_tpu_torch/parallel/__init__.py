"""Parallelism and memory modes (PyTorch port of ``more4d_tpu/parallel/``):
the device mesh on ``torch.distributed`` with FSDP2 (``mesh.py``), Ulysses
sequence-parallel attention (``ulysses.py``), and DiT blocks streamed from
pinned host memory (``offload.py``)."""

from .mesh import (AXIS_DATA, AXIS_DCN, AXIS_FSDP, AXIS_SEQ, MeshConfig,
                   create_mesh, data_sharding, fsdp_sharding,
                   parse_mesh_spec, replicated, shard_params)
from .offload import (HostBlock, StreamedDiT, make_host_blocks,
                      offload_blocks_to_host, split_block_params)
from .placement import place_dit
from .ulysses import get_mesh, seq_parallel_size, set_mesh, ulysses_attention

__all__ = [
    "AXIS_DATA", "AXIS_DCN", "AXIS_FSDP", "AXIS_SEQ", "MeshConfig",
    "create_mesh",
    "fsdp_sharding", "data_sharding", "parse_mesh_spec", "replicated",
    "shard_params",
    "set_mesh", "get_mesh", "seq_parallel_size", "ulysses_attention",
    "HostBlock", "StreamedDiT", "make_host_blocks", "offload_blocks_to_host",
    "split_block_params", "place_dit",
]
