"""Where a DiT's weights live for inference: the memory modes, on one card
or on a mesh (the JAX ``scripts/infer.py``'s placement of its DiTs, as
one function).

- resident in the compute dtype;
- ``fp8``: the eligible matrices stored in fp8 (``quantize_params_fp8``,
  unscaled, as the reference casts), widened by each layer as it runs;
- ``offload``: the blocks in pinned host memory (fp8 matrices, bf16 for
  the rest), streamed to the card a block at a time (``StreamedDiT``), the
  embeddings, head and norms resident.

On a mesh (``parallel.create_mesh``) the resident weights are sharded
with FSDP2 (``shard_params``): the whole DiT, quantized first (the cast is
elementwise, so the shards hold the bytes the unsharded fp8 DiT holds;
FSDP2 gathers a unit whose dtypes differ as bytes), or under ``offload``
the resident part alone, while each rank streams the whole blocks from a
pinned copy of its own, as the JAX CLI's ranks each keep one.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from torch import nn


def _untimed(label, fn, *a, **kw):
    return fn(*a, **kw)


def place_dit(module: nn.Module, mesh=None, fp8: bool = False,
              offload: bool = False, device="cuda",
              timed: Optional[Callable] = None
              ) -> Tuple[nn.Module, Optional[tuple]]:
    """(module, host blocks or None): ``module`` (a built ``WanDiT``)
    placed in its memory mode, in place. ``offload`` takes precedence over
    ``fp8`` (the streamed blocks are fp8 either way): the blocks are split
    off (``split_block_params``) and cast into pinned host buffers. With
    ``mesh`` the resident weights are then sharded (``shard_params``).
    ``timed(label, fn, *args)``, when given, runs each step (labels
    ``offload``, ``fp8``, ``shard``)."""
    from .mesh import shard_params
    from .offload import offload_blocks_to_host, split_block_params

    step = _untimed if timed is None else timed
    host_blocks = None
    if offload:
        module, blocks = split_block_params(module)
        host_blocks = step("offload", offload_blocks_to_host, blocks,
                           "fp8", device)
        del blocks
    elif fp8:
        from ..utils.quantize import quantize_params_fp8

        step("fp8", quantize_params_fp8, module, scaled=False)
    if mesh is not None:
        step("shard", shard_params, module, mesh)
    return module, host_blocks
