"""Optimizer and training-robustness utilities (PyTorch port of
``more4d_tpu/train/optim.py``):

- the learning-rate schedules and AdamW at the shipped defaults;
- EMA of the weights;
- the dynamic gradient-norm clamp: the max norm decays linearly and shrinks
  up to 10x when the observed norm is anomalous;
- the thresholded MSE loss and the temporal-difference motion_sub loss.

AdamW is ``torch.optim.AdamW``. Its decoupled step, p <- p (1 - lr wd) -
lr m_hat / (sqrt(v_hat) + eps), is optax.adamw's p <- p - lr (m_hat /
(sqrt(v_hat) + eps) + wd p) up to rounding. A schedule is a callable of
the optimizer-step count, as optax's are; ``make_adamw`` drives it with a
``LambdaLR`` stepped after each applied update, so the first update uses
schedule(0), as optax does.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch

Schedule = Union[float, Callable[[int], float]]


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
        import math

        main = lambda n: lr * 0.5 * (  # noqa: E731
            1 + math.cos(math.pi * min(max(n, 0), decay) / decay))
    else:
        raise ValueError(f"unknown lr_scheduler '{name}'")
    if warmup_steps <= 0:
        return main
    warm = _linear(0.0, lr, warmup_steps)
    return lambda n: warm(n) if n < warmup_steps else main(n - warmup_steps)


def make_adamw(params: Iterable[torch.nn.Parameter], lr: Schedule,
               betas=(0.9, 0.999), weight_decay: float = 3e-2,
               eps: float = 1e-10
               ) -> Tuple[torch.optim.AdamW,
                          Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """AdamW at the shipped launch defaults, and the LambdaLR that drives a
    schedule-valued ``lr`` (None for a constant). Step the scheduler after
    every applied optimizer step."""
    if not callable(lr):
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=weight_decay), None
    opt = torch.optim.AdamW(params, lr=1.0, betas=betas, eps=eps,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> None:
    """ema <- ema * decay + params * (1 - decay), in place (one foreach
    launch per op over all tensors)."""
    es = list(ema.values())
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, [params[n].to(e.dtype) for n, e in ema.items()],
                        alpha=1.0 - decay)


def global_grad_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The fp32 2-norm over every gradient."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


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
    for g in grads:
        g.copy_((g.float() * scale).to(g.dtype))
    return norm, used_max


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
