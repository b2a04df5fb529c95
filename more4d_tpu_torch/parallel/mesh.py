"""The device mesh on ``torch.distributed`` (PyTorch port of
``more4d_tpu/parallel/mesh.py``): one process a card, launched by
``torchrun``, and one ``DeviceMesh`` over four named axes.

- ``dcn``: the leading axis for several nodes; data parallelism only, so
  the parameter all-gathers and gradient reduce-scatters stay inside a
  node. ``torchrun`` numbers the ranks node by node, so ``dcn`` = the
  node count puts each node on one ``dcn`` index.
- ``data``: data parallelism. The global batch is split over ``(dcn,
  data)`` jointly (``data_sharding``); ranks that differ only in ``fsdp``
  or ``seq`` take the same rows.
- ``fsdp``: parameters, gradients, optimizer state and EMA are sharded
  over this axis with FSDP2 (``shard_params``) and replicated over the
  others (HSDP), as the JAX package never shards a parameter over
  ``dcn`` or ``data``.
- ``seq``: sequence parallelism for inference (``ulysses.py``).

The sharding rule is JAX's: shard each parameter's largest dimension that
the ``fsdp`` size divides (the later one on a tie), and leave a tensor
under ``min_size`` elements, or with no such dimension, replicated
(``fsdp_spec``). FSDP2 shards every parameter of a module it wraps, so
where JAX replicates, the port shards on dim 0 (unevenly where it must):
the layout differs, the numbers do not.

Without a process group ``create_mesh`` starts one from the environment
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``), with NCCL on the card and gloo on the
CPU unless ``backend=`` says otherwise; a single process with no such
environment gets a world of one.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device

AXIS_DCN = "dcn"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_SEQ = "seq"
AXES = (AXIS_DCN, AXIS_DATA, AXIS_FSDP, AXIS_SEQ)

# the methods of a module that the pipelines and trainers call besides
# forward; FSDP2 gathers the root's parameters around each
FORWARD_METHODS = ("embed", "finalize", "time_embed_e0")
# how long a collective may wait for the other ranks
TIMEOUT = timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    fsdp: int = -1     # -1: absorb all remaining devices
    seq: int = 1
    dcn: int = 1       # nodes: leading, data-parallel-only axis

    def resolve(self, n_devices: int) -> "MeshConfig":
        known = [v for v in (self.data, self.fsdp, self.seq, self.dcn)
                 if v != -1]
        prod = int(np.prod(known)) if known else 1
        missing = n_devices // max(prod, 1)
        fix = lambda v: missing if v == -1 else v  # noqa: E731
        out = MeshConfig(fix(self.data), fix(self.fsdp), fix(self.seq),
                         fix(self.dcn))
        if out.dcn * out.data * out.fsdp * out.seq != n_devices:
            raise AssertionError(f"mesh {out} != {n_devices} devices")
        return out


def parse_mesh_spec(spec: Optional[str]) -> Optional[MeshConfig]:
    """CLI mesh topology: 'data=2,fsdp=4' or 'dcn=2,data=1,fsdp=4'
    (unnamed axes default; -1 absorbs the remaining devices). None/''
    keeps the MeshConfig defaults (all devices on the fsdp axis)."""
    if not spec:
        return None
    kw = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in ("data", "fsdp", "seq", "dcn"):
            raise ValueError(f"unknown mesh axis {k!r} "
                             "(expected dcn/data/fsdp/seq)")
        kw[k] = int(v)
    return MeshConfig(**kw)


def world_size() -> int:
    """The number of ranks: the process group's, else what ``torchrun``
    set in the environment (1 without it)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_main_process() -> bool:
    """Rank 0, or a process with no process group: the one that writes
    files."""
    return not (dist.is_available() and dist.is_initialized()) or \
        dist.get_rank() == 0


def barrier() -> None:
    """A barrier over the world, nothing without a process group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def init_distributed(device=None, backend: Optional[str] = None) -> None:
    """Start the default process group if none is up, from ``torchrun``'s
    environment, and on the card select the rank's device (``LOCAL_RANK``
    modulo the visible cards, so that ranks may share one card). NCCL on
    the card and gloo on the CPU unless ``backend`` names one."""
    if dist.is_initialized():
        return
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ.get("RANK", "0")),
                                world_size=world, timeout=TIMEOUT)
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    else:
        raise RuntimeError(
            f"WORLD_SIZE={world} without MASTER_ADDR: launch with torchrun, "
            f"or start the process group before create_mesh")


def broadcast_from_first(tensors, group=None) -> list:
    """``tensors`` (None entries pass) made contiguous and overwritten in
    place with the copies of the first rank of ``group`` (the world's rank
    0 when None), where the ranks must work from one value that each has
    computed for itself: a rank's own copy may differ from rank 0's in its
    last bits."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    out = []
    for t in tensors:
        if t is not None:
            t = t.contiguous()
            dist.broadcast(t, src=src, group=group)
        out.append(t)
    return out


def create_mesh(config: Optional[MeshConfig] = None, device=None,
                backend: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over (dcn, data, fsdp, seq) of the whole world, -1
    resolved against the world size (``MeshConfig.resolve``). Starts the
    process group first if none is up (``init_distributed``)."""
    dev = resolve_device("cuda" if device is None else device)
    n = world_size()
    config = (config or MeshConfig()).resolve(n)    # before any group
    init_distributed(dev, backend)
    ranks = torch.arange(n).reshape(config.dcn, config.data, config.fsdp,
                                    config.seq)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis: size}, as a JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def replicated(mesh: DeviceMesh) -> Tuple:
    """The placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def data_size(mesh: DeviceMesh) -> int:
    """How many ways the batch is split: dcn x data."""
    s = mesh_shape(mesh)
    return s.get(AXIS_DCN, 1) * s.get(AXIS_DATA, 1)


def data_index(mesh: DeviceMesh) -> int:
    """This rank's batch shard: its (dcn, data) coordinate, dcn-major."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord.get(AXIS_DCN, 0) * mesh_shape(mesh).get(AXIS_DATA, 1) + \
        coord.get(AXIS_DATA, 0)


def data_rows(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows."""
    n = data_size(mesh)
    if batch % n:
        raise ValueError(f"a global batch of {batch} does not split over "
                         f"{n} data shards (dcn x data)")
    per = batch // n
    i = data_index(mesh)
    return slice(i * per, (i + 1) * per)


def data_sharding(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global batch ``x``, split over (dcn, data)
    jointly and the same on ranks that differ only in fsdp or seq (JAX's
    ``P((dcn, data), ...)``)."""
    return x[data_rows(mesh, x.shape[0])]


_GROUPS: Dict[tuple, object] = {}


def data_group(mesh: DeviceMesh):
    """The process group of the ranks holding the other batch shards, with
    this rank's fsdp and seq coordinates (the (dcn, data) sub-mesh)."""
    names = [a for a in (AXIS_DCN, AXIS_DATA) if a in mesh.mesh_dim_names]
    key = (mesh, "data")
    if key not in _GROUPS:
        sub = mesh[tuple(names)] if len(names) > 1 else mesh[names[0]]
        if len(names) > 1:
            sub = sub._flatten("dcn_data")
        _GROUPS[key] = sub.get_group()
    return _GROUPS[key]


def fsdp_spec(shape, fsdp_size: int, min_size: int = 2 ** 16) -> tuple:
    """JAX's rule as a PartitionSpec tuple: (None, 'fsdp') shards dim 1,
    () stays replicated."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return ()
    # the largest divisible dim; ties -> the later dim
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % fsdp_size == 0 and s >= best_size:
            best, best_size = i, s
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = AXIS_FSDP
    return tuple(spec)


def fsdp_sharding(params, mesh: DeviceMesh,
                  min_size: int = 2 ** 16) -> Dict[str, tuple]:
    """{name: spec} by JAX's rule for a module's parameters, or a dict of
    tensors. Tensors under ``min_size`` elements stay replicated."""
    named = params.named_parameters() if isinstance(params, nn.Module) \
        else params.items()
    size = mesh_shape(mesh)[AXIS_FSDP]
    return {n: fsdp_spec(tuple(p.shape), size, min_size) for n, p in named}


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 2-D (replicate, shard) mesh FSDP2 takes: shard over fsdp,
    replicate over dcn x data x seq."""
    key = (mesh, "fsdp")
    if key not in _GROUPS:
        order = [mesh.mesh_dim_names.index(a)
                 for a in (AXIS_DCN, AXIS_DATA, AXIS_SEQ, AXIS_FSDP)]
        ranks = mesh.mesh.permute(*order).reshape(
            -1, mesh_shape(mesh)[AXIS_FSDP])
        _GROUPS[key] = DeviceMesh(mesh.device_type, ranks,
                                  mesh_dim_names=("replicate", "shard"))
    return _GROUPS[key]


def _placement_fn(fsdp_size: int, min_size: int):
    from torch.distributed.tensor import Shard

    def place(p):
        spec = fsdp_spec(tuple(p.shape), fsdp_size, min_size)
        return Shard(spec.index(AXIS_FSDP)) if spec else Shard(0)
    return place


def shard_params(module: nn.Module, mesh: DeviceMesh,
                 min_size: int = 2 ** 16) -> nn.Module:
    """Shard ``module`` in place with FSDP2 by JAX's rule: each block of
    ``module.blocks`` (where it has them) as a unit, then the root, over
    ``fsdp_mesh(mesh)``. Gradients come out averaged over every rank,
    which is the mean over the data shards, as ranks along fsdp and seq
    hold the same rows. ``embed``, ``finalize`` and ``time_embed_e0`` are
    registered as forward methods, so the pipelines may call them apart.
    Build the optimizer after this call: it replaces the parameters."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)

    mesh2 = fsdp_mesh(mesh)
    place = _placement_fn(mesh_shape(mesh)[AXIS_FSDP], min_size)
    for unit in list(getattr(module, "blocks", ())) + [module]:
        fully_shard(unit, mesh=mesh2, shard_placement_fn=place)
    for name in FORWARD_METHODS:
        if hasattr(module, name):
            register_fsdp_forward_method(module, name)
    return module


def is_sharded(module: nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)
