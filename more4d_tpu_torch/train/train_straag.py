"""4D-STraG trainer step: full fine-tune of the 4D DiT on trajectory
latents (PyTorch port of ``more4d_tpu/train/train_straag.py``,
``make_train_step``).

One step:

- flow-matching noise: zt = (1 - sigma) x + sigma eps, target = eps - x,
  sigma indexed from the shifted training schedule by the timestep
  sampler (``draw`` makes the indices and the noise);
- the thresholded MSE, plus the motion_sub temporal-difference loss when
  enabled;
- the dynamic grad-norm clamp, then AdamW;
- the abnormal-loss skip (loss above the threshold after the start step,
  or not finite) keeps the params, the optimizer state and the EMA: it is
  decided on the host before ``optimizer.step()``;
- the EMA of the weights.

Frozen parameters (``requires_grad`` False, set by the trainer's
``trainable_filter``) get no gradient and no update. In eager PyTorch the
JAX package's fused step and its split step (``make_split_train_step``)
are the same step. Not ported yet: gradient accumulation
(``grad_accum_steps``, ``clip_in_tx``), per-parameter grad-norm reports,
CAME and the two-tier learning rate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion.flow_match import shift_sigmas
from .optim import (custom_mse_loss, dynamic_clip_norm, ema_update,
                    motion_sub_loss)
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


def should_skip_update(loss: float, global_step: int,
                       cfg: StraagTrainConfig) -> bool:
    """The abnormal-loss skip, decided on the host before the optimizer
    step: a non-finite loss, or a loss above the threshold after the start
    step."""
    if not math.isfinite(loss):
        return True
    return bool(global_step > cfg.abnormal_loss_start_step
                and loss > cfg.abnormal_loss_threshold)


def draw(cfg: StraagTrainConfig, batch: Dict[str, torch.Tensor],
         generator: torch.Generator, rank: int = 0
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(timestep indices [B] int64, noise like batch['latents'] fp32) for
    one step, from ``generator`` (on the latents' device)."""
    x = batch["latents"]
    b, dev = x.shape[0], x.device
    if cfg.uniform_sampling:
        sampler = StratifiedTimestepSampler(
            cfg.num_train_timesteps, uniform_sampling=True,
            world_size=cfg.world_size)
        idx = sampler(generator, b, rank, device=dev)
    else:
        u = timestep_density_u(generator, cfg.weighting_scheme, b,
                               cfg.logit_mean, cfg.logit_std, cfg.mode_scale,
                               device=dev)
        idx = torch.clamp((u * cfg.num_train_timesteps).long(), 0,
                          cfg.num_train_timesteps - 1)
    noise = torch.randn(x.shape, generator=generator, device=dev,
                        dtype=torch.float32)
    return idx, noise


def straag_loss(dit, cfg: StraagTrainConfig, batch, idx, noise):
    """The flow-matching loss of one batch at timestep indices ``idx`` and
    ``noise`` (the forward half of the step)."""
    x = batch["latents"].float()
    b = x.shape[0]
    sigmas = torch.from_numpy(training_schedule(
        cfg.num_train_timesteps, cfg.shift)).to(x.device)[idx]
    sigma = sigmas.reshape(b, 1, 1, 1, 1)
    zt = (1.0 - sigma) * x + sigma * noise
    target = noise - x
    pred = dit(zt, sigmas * 1000.0, batch["context"], y=batch["y"],
               y_camera=batch.get("y_camera"),
               clip_fea=batch.get("clip_fea"),
               mpm_features=batch.get("mpm_features"),
               full_ref=batch.get("full_ref"))
    loss = custom_mse_loss(pred, target,
                           weighting=loss_weighting_sd3(cfg.weighting_scheme,
                                                        sigma),
                           threshold=cfg.mse_threshold)
    if cfg.motion_sub_loss:
        sub = motion_sub_loss(pred, target)
        loss = loss * (1 - cfg.motion_sub_loss_ratio) \
            + sub * cfg.motion_sub_loss_ratio
    return loss


def train_step(dit: torch.nn.Module, optimizer: torch.optim.Optimizer,
               ema: Optional[Dict[str, torch.Tensor]],
               cfg: StraagTrainConfig, batch: Dict[str, torch.Tensor],
               idx: torch.Tensor, noise: torch.Tensor, global_step: int,
               lr_scheduler=None) -> Dict[str, float]:
    """One optimizer step on ``dit`` (in place, with ``optimizer``, its
    ``lr_scheduler`` and the ``ema`` dict of parameter copies). Returns
    the step's metrics: loss, grad_norm, skipped."""
    trainable = [p for p in dit.parameters() if p.requires_grad]
    optimizer.zero_grad(set_to_none=True)
    loss = straag_loss(dit, cfg, batch, idx, noise)
    loss.backward()
    grads = [p.grad for p in trainable if p.grad is not None]
    gnorm, _ = dynamic_clip_norm(grads, global_step, cfg.max_grad_norm,
                                 decay_steps=cfg.grad_clip_decay_steps)
    loss_value = loss.item()
    skipped = should_skip_update(loss_value, global_step, cfg)
    if not skipped:
        optimizer.step()
        if lr_scheduler is not None:
            lr_scheduler.step()
        if ema is not None:
            ema_update(ema, dict(dit.named_parameters()), cfg.ema_decay)
    optimizer.zero_grad(set_to_none=True)
    return {"loss": loss_value, "grad_norm": float(gnorm),
            "skipped": skipped}
