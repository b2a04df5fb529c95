"""4D-STraG trainer step: full fine-tune of the 4D DiT on trajectory
latents (PyTorch port of ``more4d_tpu/train/train_straag.py``,
``make_train_step``).

One step:

- flow-matching noise: zt = (1 - sigma) x + sigma eps, target = eps - x,
  sigma indexed from the shifted training schedule by the timestep
  sampler (``draw`` makes the indices and the noise);
- the thresholded MSE, plus the motion_sub temporal-difference loss when
  enabled;
- the dynamic grad-norm clamp, then the optimizer (``GradUpdate``,
  ``straag_update``);
- the abnormal-loss skip (loss above the threshold after the start step,
  or not finite) keeps the params, the optimizer state, the accumulator
  and the EMA: it is decided on the host before the optimizer step;
- the EMA of the weights, moved once an optimizer step.

With ``grad_accum_steps`` k > 1 (JAX's ``optax.MultiSteps``) each
micro-step's gradient joins a running mean and every k-th micro-step
steps the optimizer; with ``clip_in_tx`` the clamp runs once an
optimizer step on the mean, its decay counting optimizer steps (JAX's
``dynamic_clip_transform`` inside the MultiSteps chain), else on each
micro-step's gradient. The skip rule and the per-micro-step clamp take
``global_step // k``, as JAX's ``sched_step``. ``report_grad_norms`` adds
each trainable parameter's gradient norm, as JAX reports it: after the
per-micro-step clamp, or raw with ``clip_in_tx``.

Frozen parameters (``requires_grad`` False, set by the trainer's
``trainable_filter``) get no gradient and no update. In eager PyTorch the
JAX package's fused step and its split step (``make_split_train_step``)
are the same step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion.flow_match import shift_sigmas
from ..utils.profiling import span
from .optim import (DynamicClip, GradUpdate, custom_mse_loss,
                    dynamic_clip_norm, ema_update, global_grad_norm,
                    grad_norms, motion_sub_loss)
from .sampler import (StratifiedTimestepSampler, loss_weighting_sd3,
                      timestep_density_u)


def training_schedule(num_train_timesteps: int = 1000,
                      shift: float = 5.0) -> np.ndarray:
    """The flow-matching training sigmas (descending, fp32) with the shift
    applied; timesteps are sigmas * 1000."""
    s = np.linspace(1.0, 1.0 / num_train_timesteps, num_train_timesteps)
    return shift_sigmas(s, shift).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class StraagTrainConfig:
    learning_rate: float = 2e-5
    max_grad_norm: float = 0.05
    abnormal_loss_threshold: float = 0.25
    abnormal_loss_start_step: int = 50
    grad_clip_decay_steps: int = 1000
    motion_sub_loss: bool = False
    motion_sub_loss_ratio: float = 0.25
    mse_threshold: float = 50.0
    shift: float = 5.0
    num_train_timesteps: int = 1000
    uniform_sampling: bool = True
    # SD3 density sampling and loss weighting: with uniform_sampling off the
    # indices come from timestep_density_u under this scheme; the loss
    # weighting applies in either mode ('none' => ones)
    weighting_scheme: str = "none"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    world_size: int = 1
    ema_decay: float = 0.9999
    use_ema: bool = True
    # micro-batch gradient accumulation: the optimizer steps on the mean
    # gradient of every k micro-steps
    grad_accum_steps: int = 1
    # the dynamic clamp on the accumulated mean, once an optimizer step,
    # instead of on each micro-step's gradient
    clip_in_tx: bool = False


def _data_mean(x: torch.Tensor, mesh) -> float:
    """The mean of a per-rank scalar over the mesh's data shards."""
    import torch.distributed as dist

    from ..parallel.mesh import data_group, data_size

    x = x.detach().float().reshape(1).clone()
    dist.all_reduce(x, group=data_group(mesh))
    return x.item() / data_size(mesh)


def should_skip_update(loss: float, global_step: int,
                       cfg: StraagTrainConfig) -> bool:
    """The abnormal-loss skip, decided on the host before the optimizer
    step: a non-finite loss, or a loss above the threshold after the start
    step, counted in optimizer steps (``global_step`` // k)."""
    sched_step = global_step // max(cfg.grad_accum_steps, 1)
    if not math.isfinite(loss):
        return True
    return bool(sched_step > cfg.abnormal_loss_start_step
                and loss > cfg.abnormal_loss_threshold)


def straag_update(leaves, optimizer, cfg: StraagTrainConfig,
                  lr_scheduler=None) -> GradUpdate:
    """The STraG step's ``GradUpdate`` over the trainable ``leaves``:
    ``cfg.grad_accum_steps``' running mean; with ``clip_in_tx`` the
    dynamic clamp on the mean (else ``train_step`` clamps each
    micro-step's gradient)."""
    clamp = (DynamicClip(cfg.max_grad_norm,
                         decay_steps=cfg.grad_clip_decay_steps)
             if cfg.clip_in_tx else None)
    return GradUpdate(leaves, optimizer, lr_scheduler, max_grad_norm=None,
                      accum_steps=cfg.grad_accum_steps,
                      clip_mean=cfg.clip_in_tx, clamp=clamp)


def draw(cfg: StraagTrainConfig, batch: Dict[str, torch.Tensor],
         generator: torch.Generator, rank: int = 0, shards: int = 1
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(timestep indices [B] int64, noise like batch['latents'] fp32) for
    one step, from ``generator`` (on the latents' device).

    On a mesh the batch is this rank's B rows of a global batch of
    ``shards`` x B (``shards`` = dcn x data): every rank draws the global
    batch's indices and noise, so the generators stay in step, each row
    stratified by its data shard's index (row r by r // B), and keeps the
    rows of shard ``rank``. With one shard ``rank`` stratifies every row."""
    x = batch["latents"]
    b, dev = x.shape[0], x.device
    n = b * shards
    if cfg.uniform_sampling:
        sampler = StratifiedTimestepSampler(
            cfg.num_train_timesteps, uniform_sampling=True,
            world_size=cfg.world_size)
        ranks = rank if shards == 1 else \
            torch.arange(n, device=dev) // b
        idx = sampler(generator, n, ranks, device=dev)
    else:
        u = timestep_density_u(generator, cfg.weighting_scheme, n,
                               cfg.logit_mean, cfg.logit_std, cfg.mode_scale,
                               device=dev)
        idx = torch.clamp((u * cfg.num_train_timesteps).long(), 0,
                          cfg.num_train_timesteps - 1)
    noise = torch.randn((n,) + tuple(x.shape[1:]), generator=generator,
                        device=dev, dtype=torch.float32)
    if shards == 1:
        return idx, noise
    rows = slice(rank * b, (rank + 1) * b)
    return idx[rows], noise[rows]


def flow_inputs(cfg, latents: torch.Tensor, idx: torch.Tensor,
                noise: torch.Tensor):
    """(zt, t, target, loss weight) of the flow-matching step at timestep
    indices ``idx`` and ``noise``: zt = (1 - sigma) x + sigma noise, t =
    sigma * 1000, target noise - x, the SD3 weighting of sigma. ``cfg``
    gives num_train_timesteps, shift and weighting_scheme (a STraG or
    ViSM config)."""
    x = latents.float()
    b = x.shape[0]
    sigmas = torch.from_numpy(training_schedule(
        cfg.num_train_timesteps, cfg.shift)).to(x.device)[idx.to(x.device)]
    sigma = sigmas.reshape(b, 1, 1, 1, 1)
    noise = noise.to(x.device)
    zt = (1.0 - sigma) * x + sigma * noise
    return (zt, sigmas * 1000.0, noise - x,
            loss_weighting_sd3(cfg.weighting_scheme, sigma))


def straag_loss(dit, cfg: StraagTrainConfig, batch, idx, noise):
    """The flow-matching loss of one batch at timestep indices ``idx`` and
    ``noise`` (the forward half of the step)."""
    zt, t, target, weight = flow_inputs(cfg, batch["latents"], idx, noise)
    pred = dit(zt, t, batch["context"], y=batch["y"],
               y_camera=batch.get("y_camera"),
               clip_fea=batch.get("clip_fea"),
               mpm_features=batch.get("mpm_features"),
               full_ref=batch.get("full_ref"))
    loss = custom_mse_loss(pred, target, weighting=weight,
                           threshold=cfg.mse_threshold)
    if cfg.motion_sub_loss:
        sub = motion_sub_loss(pred, target)
        loss = loss * (1 - cfg.motion_sub_loss_ratio) \
            + sub * cfg.motion_sub_loss_ratio
    return loss


def train_step(dit: torch.nn.Module, update: GradUpdate,
               ema: Optional[Dict[str, torch.Tensor]],
               cfg: StraagTrainConfig, batch: Dict[str, torch.Tensor],
               idx: torch.Tensor, noise: torch.Tensor, global_step: int,
               report_grad_norms: bool = False,
               mesh=None) -> Dict[str, object]:
    """One micro-step on ``dit`` (in place, through ``update``, a
    ``straag_update`` over its trainable parameters, and the ``ema`` dict
    of parameter copies). Returns the step's metrics: loss, grad_norm (of
    the micro-step's gradient), skipped, updated (1.0 where the optimizer
    stepped), and with ``report_grad_norms`` 'grad_norms', a dict of each
    trainable parameter's gradient norm.

    On a ``mesh`` (``dit`` sharded by ``parallel.shard_params``, ``batch``
    this rank's rows) the gradients come out as the mean over the data
    shards, and the loss is that mean too, so every rank takes the same
    skip decision, as JAX's step on the global batch does."""
    trainable = [(n, p) for n, p in dit.named_parameters() if p.requires_grad]
    with span("more4d.train.forward"):
        loss = straag_loss(dit, cfg, batch, idx, noise)
    with span("more4d.train.backward"):
        loss.backward()
    with span("more4d.train.clamp"):
        # a tensor the loss does not reach has a zero gradient, as in JAX
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in trainable]
        sched_step = global_step // max(cfg.grad_accum_steps, 1)
        if cfg.clip_in_tx:
            gnorm = global_grad_norm(grads)
        else:
            gnorm, _ = dynamic_clip_norm(
                grads, sched_step, cfg.max_grad_norm,
                decay_steps=cfg.grad_clip_decay_steps)
        loss_value = loss.item() if mesh is None else _data_mean(loss, mesh)
        skipped = should_skip_update(loss_value, global_step, cfg)
        metrics = {"loss": loss_value, "grad_norm": float(gnorm),
                   "skipped": skipped, "updated": 0.0}
        if report_grad_norms:
            norms = grad_norms(grads)
            metrics["grad_norms"] = dict(zip([n for n, _ in trainable],
                                             norms.tolist()))
    with span("more4d.train.optimizer"):
        if not skipped:
            metrics["updated"] = update(grads)["updated"]
        for _, p in trainable:
            p.grad = None
    if ema is not None and metrics["updated"]:
        with span("more4d.train.ema"):
            ema_update(ema, dict(dit.named_parameters()), cfg.ema_decay)
    return metrics
