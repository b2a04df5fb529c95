"""Optimizer and training-robustness utilities (PyTorch port of
``more4d_tpu/train/optim.py``):

- the learning-rate schedules and AdamW at the shipped defaults, with the
  two-tier learning rate: a parameter group at ``lr * low_lr_ratio`` for
  the tensors whose JAX parameter path matches ``low_lr_names``
  (``scale_lr``; JAX's ``with_low_lr``, for AdamW and CAME alike);
- EMA of the weights;
- the dynamic gradient-norm clamp: the max norm decays linearly and shrinks
  up to 10x when the observed norm is anomalous (``DynamicClip``, JAX's
  ``dynamic_clip_transform`` when it clamps an accumulated mean);
- the thresholded MSE loss and the temporal-difference motion_sub loss;
- the windowed loss-outlier skip of the VAE-adaptor trainer
  (``LossOutlierTracker``, host code);
- CAME (``CAME``), the reference's ``--use_came`` optimizer;
- ``GradUpdate``, the trainers' step of the optimizer: a clip (the
  global-norm clip, or the dynamic clamp) and ``optax.MultiSteps``'
  accumulation.

AdamW is ``torch.optim.AdamW``. Its decoupled step, p <- p (1 - lr wd) -
lr m_hat / (sqrt(v_hat) + eps), is optax.adamw's p <- p - lr (m_hat /
(sqrt(v_hat) + eps) + wd p) up to rounding. A schedule is a callable of
the optimizer-step count, as optax's are; ``make_adamw`` drives it with a
``LambdaLR`` stepped after each applied update, so the first update uses
schedule(0), as optax does.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def scale_lr(lr: Schedule, ratio: float) -> Schedule:
    """lr * ratio, for a float or a schedule."""
    if callable(lr):
        return lambda n: lr(n) * ratio
    return lr * ratio


def lr_groups(params, lr: Schedule, low_lr_names: Optional[str] = None,
              low_lr_ratio: float = 0.1):
    """(parameter groups, their learning rates): one group at ``lr``, or
    with ``low_lr_names`` (a regex searched in each DiT parameter's JAX
    path, ``utils/quantize.jax_param``) a second at ``lr * low_lr_ratio``
    for the tensors it matches, as JAX's ``with_low_lr`` labels its
    tree. ``params``: tensors, or (name, tensor) pairs, which the regex
    needs. An empty group is left out."""
    params = list(params)
    if low_lr_names is None:
        return ([{"params": [p[1] if isinstance(p, tuple) else p
                             for p in params]}], [lr])
    from ..utils.quantize import jax_param

    pattern = re.compile(low_lr_names)
    high, low = [], []
    for name, p in params:
        (low if pattern.search(jax_param(name, p)[0]) else high).append(p)
    groups = [({"params": g}, r) for g, r in (
        (high, lr), (low, scale_lr(lr, low_lr_ratio))) if g]
    return [g for g, _ in groups], [r for _, r in groups]


def _with_lrs(make, groups, lrs):
    """``make(groups)`` with each group at its learning rate: constant
    rates set per group, schedules driven by one LambdaLR over lr 1."""
    if not any(callable(r) for r in lrs):
        for g, r in zip(groups, lrs):
            g["lr"] = r
        return make(groups), None
    for g in groups:
        g["lr"] = 1.0
    opt = make(groups)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, [r if callable(r) else (lambda n, r=r: r) for r in lrs])


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    return lambda n: init + (end - init) * min(max(n, 0), steps) / steps


def make_lr_schedule(lr: float, name: str = "constant",
                     warmup_steps: int = 0,
                     total_steps: int = 10000) -> Schedule:
    """A float (constant) or a schedule ``count -> lr`` over optimizer
    steps: constant / constant_with_warmup / linear / cosine. Plain
    'constant' ignores warmup_steps."""
    if name == "constant":
        return lr
    if name == "constant_with_warmup":
        if warmup_steps <= 0:
            return lr
        warm = _linear(0.0, lr, warmup_steps)
        return lambda n: warm(n) if n < warmup_steps else lr
    decay = max(total_steps - warmup_steps, 1)
    if name == "linear":
        main = _linear(lr, 0.0, decay)
    elif name == "cosine":
        main = lambda n: lr * 0.5 * (  # noqa: E731
            1 + math.cos(math.pi * min(max(n, 0), decay) / decay))
    else:
        raise ValueError(f"unknown lr_scheduler '{name}'")
    if warmup_steps <= 0:
        return main
    warm = _linear(0.0, lr, warmup_steps)
    return lambda n: warm(n) if n < warmup_steps else main(n - warmup_steps)


def make_adamw(params, lr: Schedule, betas=(0.9, 0.999),
               weight_decay: float = 3e-2, eps: float = 1e-10,
               low_lr_names: Optional[str] = None, low_lr_ratio: float = 0.1
               ) -> Tuple[torch.optim.AdamW,
                          Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """AdamW at the shipped launch defaults, and the LambdaLR that drives a
    schedule-valued ``lr`` (None for a constant). Step the scheduler after
    every applied optimizer step. ``low_lr_names``: the two-tier learning
    rate (``lr_groups``; ``params`` then as (name, tensor) pairs)."""
    groups, lrs = lr_groups(params, lr, low_lr_names, low_lr_ratio)
    return _with_lrs(lambda gs: torch.optim.AdamW(
        gs, betas=betas, eps=eps, weight_decay=weight_decay), groups, lrs)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> None:
    """ema <- ema * decay + params * (1 - decay), in place (one foreach
    launch per op over all tensors)."""
    es = list(ema.values())
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, [params[n].to(e.dtype) for n, e in ema.items()],
                        alpha=1.0 - decay)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _sharded(grads) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(g, DTensor) for g in grads)


def _square_sums(grads: List[torch.Tensor]) -> torch.Tensor:
    """fp32 [n]: each gradient's sum of squares. FSDP's DTensor gradients
    (parameters sharded by ``parallel.shard_params``) sum their shards over
    the mesh dims they are sharded on, in one all-reduce a dim."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    out = torch.stack([_local(g).float().square().sum() for g in grads])
    sharded = [i for i, g in enumerate(grads) if isinstance(g, DTensor)]
    if sharded:
        first = grads[sharded[0]]
        dims = [d for d, pl in enumerate(first.placements) if pl.is_shard()]
        if any(g.device_mesh != first.device_mesh or
               [d for d, pl in enumerate(g.placements) if pl.is_shard()]
               != dims for g in (grads[i] for i in sharded)):
            raise ValueError("gradients sharded over different mesh dims")
        part = out[sharded]
        for d in dims:
            dist.all_reduce(part, group=first.device_mesh.get_group(d))
        out[sharded] = part
    return out


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The fp32 2-norm over every gradient (the whole of each sharded
    one)."""
    grads = list(grads)
    if _sharded(grads):
        return torch.sqrt(_square_sums(grads).sum())
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def grad_norms(grads: List[torch.Tensor]) -> torch.Tensor:
    """fp32 [n]: each gradient's 2-norm (the whole of each sharded one)."""
    if _sharded(grads):
        return torch.sqrt(_square_sums(grads))
    return torch.stack(torch._foreach_norm([g.float() for g in grads]))


def linear_decay(initial: float, final: float, total_steps: int, step):
    frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
    return initial + (final - initial) * frac


@torch.no_grad()
def dynamic_clip_norm(grads, step: int, max_grad_norm: float = 0.05,
                      initial_ratio: float = 5.0, decay_steps: int = 1000):
    """Clip the gradients in place by a linearly decaying max norm; if the
    norm exceeds it by more than 5x after the decay window, shrink the
    limit up to 10x. Returns (norm, used_max) as fp32 tensors."""
    grads = list(grads)
    norm = global_grad_norm(grads)
    max_norm = linear_decay(max_grad_norm * initial_ratio, max_grad_norm,
                            decay_steps, step)
    ratio = norm / max(max_norm, 1e-12)
    if step > decay_steps:
        used_max = torch.where(ratio > 5.0,
                               max_norm / torch.clamp(ratio, max=10.0),
                               torch.full_like(norm, max_norm))
    else:
        used_max = torch.full_like(norm, max_norm)
    scale = torch.clamp(used_max / torch.clamp(norm, min=1e-12), max=1.0)
    for g in map(_local, grads):
        g.copy_((g.float() * scale).to(g.dtype))
    return norm, used_max


class DynamicClip:
    """``dynamic_clip_norm`` as a clamp with its own step count, JAX's
    ``dynamic_clip_transform``: applied once per optimizer step to the
    accumulated mean (``GradUpdate(clamp=...)``), its decay counts
    optimizer steps."""

    def __init__(self, max_grad_norm: float = 0.05,
                 initial_ratio: float = 5.0, decay_steps: int = 1000):
        self.max_grad_norm = max_grad_norm
        self.initial_ratio = initial_ratio
        self.decay_steps = decay_steps

    def __call__(self, grads, step: int):
        """Clip ``grads`` in place at optimizer step ``step``."""
        dynamic_clip_norm(grads, step, self.max_grad_norm,
                          self.initial_ratio, self.decay_steps)
        return grads


def custom_mse_loss(pred, target, weighting=None, threshold: float = 50.0):
    """MSE with |err| > threshold masked out."""
    diff = pred.float() - target.float()
    loss = diff.square() * (diff.abs() <= threshold)
    if weighting is not None:
        loss = loss * weighting.float()
    return loss.mean()


def motion_sub_loss(pred, target):
    """Temporal-difference MSE on [B, T, ...]."""
    pred, target = pred.float(), target.float()
    dp = pred[:, 1:] - pred[:, :-1]
    dt = target[:, 1:] - target[:, :-1]
    return (dp - dt).square().mean()


class LossOutlierTracker:
    """The windowed loss-outlier detector of the VAE-adaptor trainer: skip
    a batch whose loss is not finite, exceeds the absolute threshold, or
    exceeds the window's statistic, mean + sigma * std, or mean *
    multiplier when the window's std is degenerate (< 1e-6, the
    reference's early-training guard). Host code."""

    def __init__(self, window: int = 100, sigma: float = 6.0,
                 warmup: int = 20, absolute_threshold: float = 1e7,
                 multiplier: float = 10.0):
        self.window = window
        self.sigma = sigma
        self.warmup = warmup
        self.absolute_threshold = absolute_threshold
        self.multiplier = multiplier
        self.values = []

    def should_skip(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if loss > self.absolute_threshold:
            return True
        if len(self.values) >= self.warmup:
            import numpy as np

            mean = float(np.mean(self.values))
            std = float(np.std(self.values))
            threshold = (mean * self.multiplier if std < 1e-6
                         else mean + self.sigma * std)
            if loss > threshold:
                return True
        self.values.append(loss)
        if len(self.values) > self.window:
            self.values.pop(0)
        return False


class _Cut:
    """Where a parameter is cut over the mesh, for CAME's reductions: the
    tensor dim FSDP2 shards (``dim``, None for a whole tensor) and the
    process group of its mesh dim, with the whole shape. A sum over the
    cut dim adds the ranks' partial sums (one all-reduce), so the row and
    column means and the RMS are those of the whole tensor, as JAX's
    global arrays give them."""

    def __init__(self, p: torch.Tensor):
        from torch.distributed.tensor import DTensor

        self.shape, self.dim, self.group = tuple(p.shape), None, None
        self.mesh = self.placements = None
        if isinstance(p, DTensor):
            self.mesh, self.placements = p.device_mesh, p.placements
            cuts = [(i, pl.dim) for i, pl in enumerate(p.placements)
                    if pl.is_shard()]
            if len(cuts) > 1:
                raise ValueError(f"CAME: a parameter sharded over "
                                 f"{len(cuts)} mesh dims")
            if cuts:
                self.dim = cuts[0][1] % len(self.shape)
                self.group = p.device_mesh.get_group(cuts[0][0])

    def sum(self, x: torch.Tensor, dim: int, over: int,
            keepdim: bool = False) -> torch.Tensor:
        """``x`` (local) summed over its ``dim``, which is the parameter's
        dim ``over``: across the ranks when that is the cut dim."""
        s = x.sum(dim, keepdim=keepdim)
        if self.dim == over % len(self.shape):
            import torch.distributed as dist

            dist.all_reduce(s, group=self.group)
        return s

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every element of the whole tensor."""
        s = x.sum()
        if self.dim is not None:
            import torch.distributed as dist

            dist.all_reduce(s, group=self.group)
        return s

    def state(self, local: torch.Tensor, drop: int) -> torch.Tensor:
        """A statistic with the parameter's dim ``drop`` reduced away, as
        this rank holds it (``local``): a DTensor cut where the parameter
        is (the dim renumbered), whole where the reduced dim was the cut
        one; a plain tensor for a whole parameter."""
        if self.mesh is None:
            return local
        from torch.distributed.tensor import DTensor

        placements = came_state_placements(self.placements, len(self.shape),
                                           drop)
        shape = self.shape[:drop % len(self.shape)] + \
            self.shape[drop % len(self.shape) + 1:]
        return DTensor.from_local(
            local, self.mesh, placements, run_check=False,
            shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())


def came_state_placements(placements, ndim: int, drop: int):
    """The placements of a CAME statistic (``v_r``/``r_r`` drop the
    parameter's last dim, ``v_c``/``r_c`` its second to last) of a
    parameter of ``ndim`` dims laid out as ``placements``: replicated
    where the dropped dim was the cut one, else cut on the same dim,
    renumbered past the dropped one."""
    from torch.distributed.tensor import Replicate, Shard

    drop = drop % ndim
    out = []
    for pl in placements:
        if pl.is_shard():
            d = pl.dim % ndim
            pl = Replicate() if d == drop else Shard(d - (d > drop))
        out.append(pl)
    return tuple(out)


# CAME's factored statistics: {state key: the parameter dim it reduces}
CAME_FACTORED = {"v_r": -1, "r_r": -1, "v_c": -2, "r_c": -2}


def _factored_rsqrt(cut: _Cut, stat_r, stat_c):
    """1/sqrt(v) rebuilt from a matrix's row and column statistics
    (Adafactor eq. 4); ``stat_r``'s last dim is the parameter's dim -2."""
    mean = cut.sum(stat_r, -1, -2, keepdim=True) / cut.shape[-2]
    r = stat_r / mean.clamp_min(1e-30)
    return torch.rsqrt((r[..., None] * stat_c[..., None, :]).clamp_min(1e-30))


class CAME(torch.optim.Optimizer):
    """CAME (Luo et al. 2023), the reference's ``--use_came``: Adafactor's
    factored second moments with a confidence-guided rescaling of the
    first moment, as the JAX package's ``came`` computes it. Per step, a
    matrix's statistics factored over its last two dims, a vector's kept
    whole:

        u   = g / sqrt(EMA_b2[g^2 + eps1])
        u   = u / max(1, RMS(u) / clip_threshold)
        m   = b1 m + (1 - b1) u
        r   = EMA_b3[(u - m)^2 + eps2]     (matrices only)
        upd = m / sqrt(r) for a matrix, m for a vector
        p  <- p - lr (upd + weight_decay p)

    in float32, the state in the parameter's dtype. The learning rate is
    the group's ``lr`` (drive a schedule with a ``LambdaLR`` over lr 1, as
    ``make_adamw`` does). The row/column factorisation gives the same
    update for a matrix and its transpose up to rounding, so torch's
    [out, in] layout matches JAX's [in, out].

    On FSDP2's DTensor parameters (``parallel.shard_params``) each rank
    updates its shard: the means over a cut dim and the RMS add the ranks'
    partial sums (``_Cut``), so every number is the whole tensor's, a
    shard of any size, an empty one included. ``m`` is laid out as its
    parameter; the factored statistics are cut where their parameter is,
    or whole where their reduced dim was the cut one
    (``came_state_placements``)."""

    def __init__(self, params, lr: float = 1e-4,
                 betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16),
                 weight_decay: float = 1e-2, clip_threshold: float = 1.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      clip_threshold=clip_threshold))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, b3 = group["betas"]
            eps1, eps2 = group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                self._update(p, self.state[p], group, b1, b2, b3, eps1,
                             eps2)
        return loss

    @staticmethod
    def _update(p, state, group, b1, b2, b3, eps1, eps2):
        cut = _Cut(p)
        g = _local(p.grad).float()
        factored = g.dim() >= 2
        if not state:
            state["m"] = torch.zeros_like(p)
            if factored:
                for k, drop in CAME_FACTORED.items():
                    shape = g.shape[:drop % g.dim()] + \
                        g.shape[drop % g.dim() + 1:]
                    state[k] = cut.state(g.new_zeros(shape, dtype=p.dtype),
                                         drop)
            else:
                state["v"] = torch.zeros_like(p)
        st = {k: _local(v) for k, v in state.items()}
        sq = g * g + eps1
        if factored:
            st["v_r"].mul_(b2).add_((1 - b2) * cut.sum(sq, -1, -1)
                                    / cut.shape[-1])
            st["v_c"].mul_(b2).add_((1 - b2) * cut.sum(sq, -2, -2)
                                    / cut.shape[-2])
            u = g * _factored_rsqrt(cut, st["v_r"].float(),
                                    st["v_c"].float())
        else:
            st["v"].mul_(b2).add_((1 - b2) * sq)
            u = g * torch.rsqrt(st["v"].float().clamp_min(1e-30))
        rms = torch.sqrt(cut.total(u * u) / math.prod(cut.shape) + 1e-30)
        u = u / torch.clamp_min(rms / group["clip_threshold"], 1.0)
        m = st["m"].mul_(b1).add_((1 - b1) * u)
        if factored:
            inst = (u - m) ** 2 + eps2
            st["r_r"].mul_(b3).add_((1 - b3) * cut.sum(inst, -1, -1)
                                    / cut.shape[-1])
            st["r_c"].mul_(b3).add_((1 - b3) * cut.sum(inst, -2, -2)
                                    / cut.shape[-2])
            upd = m.float() * _factored_rsqrt(cut, st["r_r"].float(),
                                              st["r_c"].float())
        else:
            upd = m.float()
        w = _local(p)
        if group["weight_decay"]:
            upd = upd + group["weight_decay"] * w.float()
        w.add_((-group["lr"] * upd).to(w.dtype))


class GradUpdate:
    """The update of trained tensors after each micro-step's gradients:
    clipped, then, as ``optax.MultiSteps`` does with ``accum_steps`` > 1,
    their running mean over the micro-steps, handed to ``optimizer`` on
    every k-th; the ``lr_scheduler`` counts those optimizer steps.

    The clip: by the global norm at ``max_grad_norm``
    (optax.clip_by_global_norm: g / norm * max_norm where the norm exceeds
    max_norm; the LoRA factors, the adaptor trainer's weights), or with
    ``clamp`` a ``DynamicClip`` at the count of optimizer steps taken (the
    STraG trainer's), or none with ``max_grad_norm`` None. It clips each
    micro-step's gradients, or with ``clip_mean`` the accumulated mean
    once per optimizer step (MultiSteps(chain(clip, optimizer)))."""

    def __init__(self, leaves: List[torch.Tensor], optimizer,
                 lr_scheduler=None, max_grad_norm: Optional[float] = 1.0,
                 accum_steps: int = 1, clip_mean: bool = False,
                 clamp: Optional[DynamicClip] = None):
        self.leaves, self.optimizer = leaves, optimizer
        self.lr_scheduler = lr_scheduler
        self.max_grad_norm = (None if max_grad_norm is None
                              else float(max_grad_norm))
        self.clamp = clamp
        self.accum_steps = max(int(accum_steps), 1)
        self.clip_mean = bool(clip_mean)
        self.mini_step = 0
        self.steps = 0          # optimizer steps taken
        self.acc = ([torch.zeros_like(p) for p in leaves]
                    if self.accum_steps > 1 else None)

    def _clip(self, grads):
        if self.clamp is not None:
            return self.clamp(grads, self.steps)
        if self.max_grad_norm is None:
            return grads
        norm = global_grad_norm(grads)
        if norm >= self.max_grad_norm:
            grads = [g / norm * self.max_grad_norm for g in grads]
        return grads

    @torch.no_grad()
    def __call__(self, grads: List[torch.Tensor]) -> Dict[str, float]:
        """Take one micro-step's gradients (one a leaf, in order); returns
        {'grad_norm' (of these gradients, before any clip), 'updated' (1.0
        where the optimizer stepped)}."""
        norm = global_grad_norm(grads)
        if not self.clip_mean:
            grads = self._clip(grads)
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return {"grad_norm": float(norm), "updated": 0.0}
            grads = self.acc            # zeroed after the step below
        if self.clip_mean:
            grads = self._clip(grads)
        for p, g in zip(self.leaves, grads):
            p.grad = g.to(p.dtype)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
        self.steps += 1
        return {"grad_norm": float(norm), "updated": 1.0}

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "lr_scheduler": (None if self.lr_scheduler is None
                                 else self.lr_scheduler.state_dict()),
                "mini_step": self.mini_step, "steps": self.steps,
                "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(state["lr_scheduler"])
        self.mini_step = int(state["mini_step"])
        self.steps = int(state.get("steps", 0))
        if self.acc is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)


def make_optimizer(name: str, params, lr: Schedule, betas=(0.9, 0.999),
                   weight_decay: float = 3e-2, eps: float = 1e-10,
                   low_lr_names: Optional[str] = None,
                   low_lr_ratio: float = 0.1):
    """(optimizer, LambdaLR or None) for the trainers' ``--optimizer``:
    'adamw' (``make_adamw``) or 'came' (CAME at its own betas and eps,
    with ``weight_decay``), either with the two-tier learning rate
    (``lr_groups``)."""
    if name == "adamw":
        return make_adamw(params, lr, betas, weight_decay, eps,
                          low_lr_names, low_lr_ratio)
    if name != "came":
        raise ValueError(f"unknown optimizer '{name}'")
    groups, lrs = lr_groups(params, lr, low_lr_names, low_lr_ratio)
    return _with_lrs(lambda gs: CAME(gs, weight_decay=weight_decay), groups,
                     lrs)
