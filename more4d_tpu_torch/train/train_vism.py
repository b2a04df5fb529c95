"""4D-ViSM trainer step: LoRA fine-tune of the Wan-Fun-InP inpainting DiT
(PyTorch port of ``more4d_tpu/train/train_vism.py``).

Only the LoRA factors train (rank 4, lr 1e-4 in the reference). The
conditioning is y = [4-channel folded mask latents | masked-video latents],
as the inpaint pipeline builds it; a t2v sample has it zeroed at data
preparation. One step:

- timestep indices from the rank-stratified sampler, or the SD3 density
  sampler with ``uniform_sampling=False`` (``train_straag.draw`` makes the
  indices and the noise; tests hand the JAX step's own draws in);
- zt = (1 - sigma) x + sigma noise, target noise - x;
- the thresholded MSE with the SD3 loss weighting, and the motion_sub
  term when enabled;
- the gradients of the factors only, clipped by their global norm, then
  the optimizer (``optim.GradUpdate``, which also accumulates micro-steps
  as ``optax.MultiSteps`` does).

The forward merges W + multiplier * (alpha / rank) * up @ down into a dict
of the LoRA'd weights, differentiably, and runs the model with them in
place of its own (``torch.func.functional_call``), as the JAX package's
``apply_lora`` inside its loss does; the base weights never require a
gradient. The backward runs inside the same call: the DiT's remat
(non-reentrant ``torch.utils.checkpoint``) recomputes its blocks during
the backward, and they must read the merged weights then too.

Text-encoder LoRA (``--train_text_encoder``): the umT5 tower runs inside
the loss with its own merged factors (``lora.TE_LORA_TARGETS``), its
padded positions zeroed by the attention mask, and both factor sets train
under one optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch import nn

from .optim import GradUpdate, custom_mse_loss, motion_sub_loss
from .train_straag import flow_inputs


@dataclasses.dataclass(frozen=True)
class VismTrainConfig:
    learning_rate: float = 1e-4
    max_grad_norm: float = 1.0
    mse_threshold: float = 50.0
    shift: float = 5.0
    num_train_timesteps: int = 1000
    uniform_sampling: bool = True
    # SD3 density sampling and loss weighting
    weighting_scheme: str = "none"
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    # the temporal-difference term over frames (dim 1 of [B, T, ...])
    motion_sub_loss: bool = False
    motion_sub_loss_ratio: float = 0.25
    world_size: int = 1
    lora_multiplier: float = 1.0


def vism_loss(pred, target, loss_weight, cfg: VismTrainConfig):
    """The thresholded, weighted MSE, mixed with the motion_sub term when
    enabled (and there are more than two frames)."""
    loss = custom_mse_loss(pred, target, weighting=loss_weight,
                           threshold=cfg.mse_threshold)
    if cfg.motion_sub_loss and pred.shape[1] > 2:
        sub = motion_sub_loss(pred, target)
        loss = loss * (1 - cfg.motion_sub_loss_ratio) \
            + sub * cfg.motion_sub_loss_ratio
    return loss


def factor_leaves(lora) -> List[torch.Tensor]:
    """The trainable tensors of a LoRA (or of {'dit': ..., 'te': ...}), in
    a fixed order: each factor's down, then up, by weight name."""
    if "factors" not in lora:
        return [t for part in sorted(lora) for t in factor_leaves(lora[part])]
    return [f[k] for _, f in sorted(lora["factors"].items())
            for k in ("down", "up")]


def merged_weights(module: nn.Module, lora, multiplier: float = 1.0
                   ) -> Dict[str, torch.Tensor]:
    """{weight name: W + multiplier * (alpha / rank) * up @ down} for every
    LoRA'd weight of ``module``, differentiable in the factors and in W's
    dtype (the JAX package's ``apply_lora``: the delta is cast to W's
    dtype before the add)."""
    scale = multiplier * lora["alpha"] / lora["rank"]
    params = dict(module.named_parameters())
    out = {}
    for name, f in lora["factors"].items():
        w = params[name]
        out[name] = w + scale * (f["up"] @ f["down"]).to(w.dtype)
    return out


class _Modules(nn.Module):
    """The DiT (and the text encoder) under one root, so that one
    ``functional_call`` replaces the weights of both."""

    def __init__(self, dit, text_encoder=None):
        super().__init__()
        self.dit = dit
        if text_encoder is not None:
            self.te = text_encoder

    def forward(self, fn):
        return fn()


def loss_and_grads(dit, cfg: VismTrainConfig, lora, batch, idx, noise,
                   text_encoder=None):
    """(loss as a float, the gradients of ``factor_leaves(lora)``) of one
    batch. ``lora`` is the DiT's LoRA, or {'dit': ..., 'te': ...} with
    ``text_encoder`` (the batch then carries 'input_ids' and optionally
    'attention_mask' in place of 'context')."""
    leaves = factor_leaves(lora)
    zt, t, target, weight = flow_inputs(cfg, batch["latents"], idx, noise)
    with torch.enable_grad():
        for leaf in leaves:
            leaf.requires_grad_(True)
        mult = cfg.lora_multiplier
        if text_encoder is not None:
            params = {"dit." + k: v for k, v in merged_weights(
                dit, lora["dit"], mult).items()}
            params.update({"te." + k: v for k, v in merged_weights(
                text_encoder, lora["te"], mult).items()})
        else:
            params = {"dit." + k: v for k, v in merged_weights(
                dit, lora, mult).items()}

        def run():
            if text_encoder is not None:
                mask = batch.get("attention_mask")
                context = text_encoder(batch["input_ids"], mask).float()
                if mask is not None:
                    # zero the padded positions (the reference truncates the
                    # prompt embeddings to their lengths)
                    context = context * mask[..., None].float()
            else:
                context = batch["context"]
            pred = dit(zt, t, context, y=batch["y"],
                       clip_fea=batch.get("clip_fea"))
            loss = vism_loss(pred, target, weight, cfg)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        loss, grads = torch.func.functional_call(
            _Modules(dit, text_encoder), params, (run,))
    return loss.item(), list(grads)


def train_step(dit, update: GradUpdate, cfg: VismTrainConfig, lora, batch,
               idx, noise, text_encoder=None) -> Dict[str, float]:
    """One micro-step of the ViSM trainer: the factors' gradients, then
    ``update``. Returns the step's metrics: loss, grad_norm, updated."""
    loss, grads = loss_and_grads(dit, cfg, lora, batch, idx, noise,
                                 text_encoder)
    return {"loss": loss, **update(grads)}

