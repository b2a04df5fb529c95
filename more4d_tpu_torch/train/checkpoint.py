"""Checkpoint and resume (PyTorch port of
``more4d_tpu/train/checkpoint.py``; ``torch.save`` of state dicts where the
JAX package uses orbax).

A checkpoint is a directory ``<directory>/<step>/`` holding ``state.pt``
(the saved trees: params, and where given the optimizer state, the EMA and
any other named tree of tensors and plain values; it is loaded with
``weights_only=True``, so it unpickles no code) and ``extra.json`` (JSON
metadata such as the global step and the data sampler's position).
``max_to_keep`` keeps the newest checkpoints and deletes the older ones
after each save.

On a mesh the layout is the same: ``full_tree`` gathers every sharded
tensor (FSDP's DTensors) whole onto rank 0's host, every rank taking
part, and rank 0 saves; on restore every rank reads the file and keeps its shards
(``shard_tree``, ``shard_optimizer_state``), so a checkpoint resumes on
any mesh, a one-process run's included, as orbax restores a sharded tree
under any mesh.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, "state.pt")))

    def save(self, step: int, params: Any, opt_state: Any = None,
             ema: Any = None, extra: Optional[dict] = None, **trees):
        """params / opt_state / ema / trees: state dicts (or any tree
        torch.save takes); extra: JSON-serialisable metadata. The step's
        directory appears only once complete."""
        state = {"params": params, **trees}
        if opt_state is not None:
            state["opt_state"] = opt_state
        if ema is not None:
            state["ema"] = ema
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra if extra is not None else {}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, with_extra: bool = False,
                map_location=None) -> Optional[dict]:
        """Every saved tree of ``step`` (the latest by default) by name,
        plus ``extra`` when asked; None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        out = torch.load(os.path.join(path, "state.pt"),
                         map_location=map_location, weights_only=True)
        if with_extra:
            with open(os.path.join(path, "extra.json")) as f:
                out["extra"] = json.load(f)
        return out

    def restore_extra(self, step: Optional[int] = None) -> Optional[dict]:
        """``extra.json`` of ``step`` (the latest by default) alone, None
        when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        with open(os.path.join(self.directory, str(step),
                               "extra.json")) as f:
            return json.load(f)

    def restore_params(self, step: Optional[int] = None,
                       item: str = "params", map_location=None):
        """One saved tree: 'params', or 'ema' for the EMA weights."""
        out = self.restore(step, map_location=map_location)
        if out is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return out[item]

    def close(self):
        """Nothing to flush: every save is complete when it returns."""


def refuse_orbax(path: str) -> None:
    """Raise for an orbax checkpoint directory (``<step>/params``, what the
    JAX package's trainers write): the port reads the directories of its
    own ``CheckpointManager``, and a released or converted file."""
    import glob

    if (os.path.isdir(path) and glob.glob(os.path.join(path, "*", "params"))
            and not glob.glob(os.path.join(path, "*", "state.pt"))):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory of the JAX trainers; "
            f"the port reads its own train/checkpoint.py directories, "
            f"released .safetensors/.pth files and kohya LoRAs")


def full_tree(tree):
    """``tree`` (dicts, lists, tuples of tensors and plain values) with
    every DTensor gathered whole onto the host of rank 0; the other ranks
    get None in its place. A collective: every rank calls it, in the same
    order."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    keep = not dist.is_initialized() or dist.get_rank() == 0

    def walk(t):
        if isinstance(t, DTensor):
            whole = t.full_tensor()
            return whole.cpu() if keep else None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(tree)


def shard_like(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's part of the whole tensor ``full`` as a DTensor laid out
    as ``like`` (every rank holds ``full``; nothing is sent)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device, like.dtype),
                             like.device_mesh, like.placements,
                             src_data_rank=None)


def shard_tree(full, like):
    """``full`` (a tree of whole tensors) with each tensor whose
    counterpart in ``like`` is a DTensor cut to this rank's part."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor):
        return shard_like(full, like)
    if isinstance(full, dict) and isinstance(like, dict):
        return {k: shard_tree(v, like[k]) if k in like else v
                for k, v in full.items()}
    if isinstance(full, (list, tuple)) and isinstance(like, (list, tuple)):
        return type(full)(shard_tree(f, l) for f, l in zip(full, like))
    return full


def shard_optimizer_state(state: dict, optimizer) -> dict:
    """A torch optimizer's state dict of whole tensors (parameters
    numbered in ``optimizer``'s order) with every per-parameter tensor of
    a sharded parameter's shape cut to this rank's part, and CAME's
    factored statistics (``v_r``, ``r_r``, ``v_c``, ``r_c``) cut where
    their parameter is cut (``optim.came_state_placements``: whole where
    the dim they reduce was the cut one)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from .optim import CAME_FACTORED, came_state_placements

    params = [p for g in optimizer.param_groups for p in g["params"]]

    def cut(i, k, v):
        p = params[i]
        if not (isinstance(p, DTensor) and torch.is_tensor(v) and v.dim()):
            return v
        if tuple(v.shape) == tuple(p.shape):
            return shard_like(v, p)
        drop = CAME_FACTORED.get(k)
        shape = None if drop is None else \
            p.shape[:drop % p.dim()] + p.shape[drop % p.dim() + 1:]
        if shape is None or tuple(v.shape) != tuple(shape):
            raise ValueError(
                f"optimizer state {k!r} of shape {tuple(v.shape)} for a "
                f"sharded parameter of shape {tuple(p.shape)}")
        return distribute_tensor(
            v.to(p.device, p.dtype), p.device_mesh,
            came_state_placements(p.placements, p.dim(), drop),
            src_data_rank=None)

    return {"state": {i: {k: cut(int(i), k, v) for k, v in st.items()}
                      for i, st in state["state"].items()},
            "param_groups": state["param_groups"]}
