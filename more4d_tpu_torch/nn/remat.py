"""Selective rematerialisation of the DiT's blocks (the remat policies of
``more4d_tpu/models/wan_dit.py:70 remat_policy_of``).

A rematerialised block keeps its input and runs again in the backward
(``torch.utils.checkpoint``). A policy other than 'nothing' keeps some of
the block's values from the forward, and the run in the backward takes
them instead of computing them:

- 'dots': every matrix product without batch dims (``aten.mm``,
  ``aten.addmm``: the block's Linear layers; JAX's
  ``dots_with_no_batch_dims_saveable``), through PyTorch's selective
  checkpoint (``create_selective_checkpoint_contexts``), which sees every
  dispatched op;
- 'flash_lite': K1's (o, lse) in the self-attention, which JAX names
  ``sa_o`` and ``sa_lse`` inside its custom VJP: the backward's run
  skips the self-attention forward;
- 'flash': also the post-RoPE q, k and v (``sa_q``, ``sa_k``, ``sa_v``);
- 'flash_ffn': also the FFN's fc1 output (``ffn_hidden``);
- '<base>_offload': the same values, parked in pinned host memory between
  the forward and the backward instead of on the card (``HostOffload``).

The 'flash*' policies do without a dispatch mode, whose Python call on
every op of the forward and of the backward's run costs more host time
than the attention it saves: each block's run sets a store (``_Store``)
through the checkpoint's two contexts, the code that makes a named value
keeps it there in the forward and takes it back in the backward's run.
K1 (the op ``more4d_torch::flash_attn``, ``kernels/flash_attention.py``)
does so inside the op, below autograd, so its backward still sees q, k
and v; a value named by :func:`checkpoint_name` comes back as the same
node of the graph. In eager PyTorch the backward's run still computes
what leads to a named value, so q, k, v and fc1's output cost their
memory and save no work: RoPE's, the norms' and GELU's backward need
their inputs (in JAX the projections run again too).

Every policy gives the numbers of 'nothing': a kept value is the one the
backward's run would compute again.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, Dict, FrozenSet, List, Optional

import torch

REMAT_POLICIES = ("nothing", "dots", "flash", "flash_lite", "flash_ffn",
                  "flash_offload", "flash_lite_offload", "flash_ffn_offload")

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

# the running block's store and whether it keeps ("keep") or gives back
# ("take")
_STORE: contextvars.ContextVar = contextvars.ContextVar("remat_store",
                                                        default=None)


def saved_names(policy: str) -> FrozenSet[str]:
    """The names a 'flash*' policy keeps (empty for 'nothing' and 'dots');
    raises for a policy that is not one of REMAT_POLICIES."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy '{policy}'; one of "
                         f"{', '.join(REMAT_POLICIES)}")
    base = policy.removesuffix("_offload")
    if not base.startswith("flash"):
        return frozenset()
    names = {"sa_o", "sa_lse"}
    if base in ("flash", "flash_ffn"):
        names |= {"sa_q", "sa_k", "sa_v"}
    if base == "flash_ffn":
        names.add("ffn_hidden")
    return frozenset(names)


def kept(name: str, make: Callable):
    """``make()``'s result, a tensor or tuple of tensors, named ``name``:
    kept by the running block's store in its forward, given back by it in
    the backward's run (``make`` not called), or made where no policy
    keeps ``name``."""
    entry = _STORE.get()
    if entry is None or name not in entry[0].names:
        return make()
    store, mode = entry
    if mode == "take":
        return store.take(name)
    out = make()
    store.keep(name, out)
    return out


class _Same(torch.autograd.Function):
    """``kept``'s value in place of ``x`` (equal bits), the gradient
    passed on to ``x``."""

    @staticmethod
    def forward(ctx, x, value):
        return value

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` named ``name`` (JAX's ``checkpoint_name``): kept by a policy
    that keeps it, and in the backward's run its kept copy, joined to the
    graph where ``x`` is."""
    entry = _STORE.get()
    if entry is None or name not in entry[0].names:
        return x
    value = kept(name, lambda: x)
    return x if entry[1] == "keep" else _Same.apply(x, value)


class Remat:
    """How one forward's rematerialised blocks run under ``policy``:
    ``run(block, *args)`` checkpoints ``block``. The 'flash*' policies'
    stores hold the kept values on the card, or with '_offload' in pinned
    host memory through one copy stream of ``device`` (a ``HostOffload``
    for this forward)."""

    def __init__(self, policy: str, device: torch.device):
        self.names = saved_names(policy)
        self.context_fn = None
        if policy.removesuffix("_offload") == "dots":
            from torch.utils.checkpoint import (
                CheckpointPolicy, create_selective_checkpoint_contexts)

            def sac_policy(ctx, func, *args, **kwargs):
                return (CheckpointPolicy.MUST_SAVE if func in _MATMULS
                        else CheckpointPolicy.PREFER_RECOMPUTE)

            self.context_fn = functools.partial(
                create_selective_checkpoint_contexts, sac_policy)
        elif self.names:
            names = self.names
            offload = (HostOffload(device) if policy.endswith("_offload")
                       else None)
            last: List[Optional[_Store]] = [None]

            def contexts():
                last[0] = _Store(names, offload, last[0])
                return last[0].mode("keep"), last[0].mode("take")

            self.context_fn = contexts

    def run(self, block, *args):
        kw = {} if self.context_fn is None else {"context_fn":
                                                 self.context_fn}
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False, **kw)


class _Store:
    """One block's kept values by name, in the forward's order, on the
    card or (``offload``) in host memory. ``before``: the store of the
    block before it in this forward; the backward reaches the blocks in
    reverse, and a block's run in the backward starts the copies of the
    block before it."""

    def __init__(self, names, offload: Optional["HostOffload"],
                 before: Optional["_Store"]):
        self.names, self.offload, self.before = names, offload, before
        self.values: Dict[str, List] = {}
        self.on_device, self.ready = None, None

    @contextlib.contextmanager
    def mode(self, mode: str):
        if mode == "take" and self.offload is not None:
            self.prefetch()
            if self.before is not None:
                self.before.prefetch()
        token = _STORE.set((self, mode))
        try:
            yield
        finally:
            _STORE.reset(token)

    def keep(self, name, out):
        tensors = [t.detach() for t in (out if isinstance(out, tuple)
                                        else (out,))]
        if self.offload is not None:
            tensors = [self.offload.to_host(t) for t in tensors]
        self.values.setdefault(name, []).append((tensors,
                                                 isinstance(out, tuple)))

    def prefetch(self):
        """Start this block's copies back to the card (once)."""
        if self.on_device is None:
            hosts = [t for vs in self.values.values() for ts, _ in vs
                     for t in ts]
            moved, self.ready = self.offload.to_device(hosts)
            self.on_device = {id(h): d for h, d in zip(hosts, moved)}

    def take(self, name):
        tensors, is_tuple = self.values[name].pop(0)
        if self.offload is not None:
            self.prefetch()
            self.offload.wait(self.ready)
            tensors = [self.on_device.pop(id(h)) for h in tensors]
        tensors = [t.detach() for t in tensors]
        return tuple(tensors) if is_tuple else tensors[0]


class HostOffload:
    """The '_offload' policies' host memory: each kept tensor is copied to
    pinned host memory on a copy stream as the forward makes it, and back
    on that stream when the backward reaches its block (or the block
    after it). The copy stream waits for the op that made a tensor, the
    tensor is recorded on the copy stream so the allocator keeps it until
    its copy has run, and the compute stream waits for a block's copies
    back before it uses them. A CPU tensor is kept as a copy in host
    memory."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            host.copy_(t, non_blocking=True)
        t.record_stream(self.stream)
        return host

    def to_device(self, hosts):
        """(device tensors, event): copies started on the copy stream,
        allocated there and recorded on the compute stream that uses
        them."""
        if self.stream is None:
            return [h.clone() for h in hosts], None
        with torch.cuda.stream(self.stream):
            out = [h.to(self.device, non_blocking=True) for h in hosts]
            ready = torch.cuda.Event()
            ready.record(self.stream)
        compute = torch.cuda.current_stream(self.device)
        for t in out:
            t.record_stream(compute)
        return out, ready

    def wait(self, ready):
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
