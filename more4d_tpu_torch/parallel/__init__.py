"""Memory modes for models larger than the card (PyTorch port of
``more4d_tpu/parallel/``; the mesh and Ulysses attention are not ported
yet)."""

from .offload import (HostBlock, StreamedDiT, make_host_blocks,
                      offload_blocks_to_host, split_block_params)

__all__ = ["HostBlock", "StreamedDiT", "make_host_blocks",
           "offload_blocks_to_host", "split_block_params"]
