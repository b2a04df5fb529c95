"""VAE trajectory-adaptor trainer step (PyTorch port of
``more4d_tpu/train/train_vae.py``).

The encoder adaptor maps normalised xyz scene flow to pseudo-RGB ([0, 1],
then *2-1); the frozen causal VAE encodes it; the posterior is sampled
with its log-variance clipped to [-30, 20]; the VAE decodes (its decoder
and ``conv2`` trainable with ``finetune_decoder``); the decoder adaptor
maps the decoded RGB back to flow.

Loss = sum(L1 or L2) / B + kl_scale * sum(KL) / B with KL = 0.5 * (mu^2 +
var - 1 - logvar) per element, kl_scale 1e-6.

The reference wraps the VAE's encode in ``torch.no_grad``, which cuts the
only gradient path to the encoder adaptor, so as released it never
trains. ``encoder_grad_through_vae=True`` (the default) keeps that
gradient; False is the reference's literal behaviour.

The posterior noise comes from the caller (the CLI draws it from a
``torch.Generator``; tests hand in the JAX step's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from .optim import GradUpdate


@dataclasses.dataclass(frozen=True)
class VAEAdaptorTrainConfig:
    learning_rate: float = 5e-6
    kl_scale: float = 1e-6
    finetune_decoder: bool = True
    rec_loss: str = "l1"                   # 'l1' | 'l2'
    max_grad_norm: float = 1.0
    encoder_grad_through_vae: bool = True


def trainable_params(enc, dec, vae, cfg: VAEAdaptorTrainConfig
                     ) -> List[torch.Tensor]:
    """The parameters that train: both adaptors' and, with
    ``finetune_decoder``, the VAE's decoder and ``conv2``. Every parameter
    of the three modules is set to require a gradient exactly when it
    trains."""
    out = []
    for module in (enc, dec, vae):
        for name, p in module.named_parameters():
            train = module is not vae or (
                cfg.finetune_decoder
                and name.startswith(("decoder.", "conv2.")))
            p.requires_grad_(train)
            if train:
                out.append(p)
    return out


def vae_adaptor_loss(enc, dec, vae, cfg: VAEAdaptorTrainConfig,
                     flow: torch.Tensor, eps: torch.Tensor):
    """(loss, nll, kl) of one batch of flow [B,T,H,W,3] with posterior
    noise ``eps`` (the shape of the latents)."""
    flow = flow.float()
    b = flow.shape[0]
    pseudo = enc(flow) * 2.0 - 1.0
    if not cfg.encoder_grad_through_vae:
        pseudo = pseudo.detach()
    mu, logvar = vae.encode(pseudo)
    logvar_c = logvar.clamp(-30.0, 20.0)
    z = mu + torch.exp(0.5 * logvar_c) * eps.to(mu.device, mu.dtype)
    out = dec(vae.decode(z, clip=False))
    err = out.float() - flow
    rec = err.abs() if cfg.rec_loss == "l1" else err.square()
    nll = rec.sum() / b
    kl = 0.5 * (mu.float().square() + torch.exp(logvar_c.float()) - 1.0
                - logvar_c.float()).sum() / b
    return nll + cfg.kl_scale * kl, nll, kl


def train_step(enc, dec, vae, params: List[torch.Tensor],
               update: GradUpdate, cfg: VAEAdaptorTrainConfig, batch,
               eps: torch.Tensor,
               should_skip: Optional[Callable[[float], bool]] = None
               ) -> Dict[str, float]:
    """One micro-step: the loss's gradients of ``params`` (the values of
    ``trainable_params``), then ``update`` unless ``should_skip(loss)``
    says to drop the batch. Returns loss, nll_loss, kl_loss (and
    grad_norm, updated and skipped)."""
    loss, nll, kl = vae_adaptor_loss(enc, dec, vae, cfg, batch["flow"], eps)
    # with encoder_grad_through_vae off the encoder adaptor is off the
    # graph: its gradient is zeros, as JAX's is
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params, torch.autograd.grad(loss, params, allow_unused=True))]
    m = {"loss": loss.item(), "nll_loss": nll.item(), "kl_loss": kl.item()}
    if should_skip is not None and should_skip(m["loss"]):
        return {**m, "skipped": 1.0}
    return {**m, **update(grads), "skipped": 0.0}
