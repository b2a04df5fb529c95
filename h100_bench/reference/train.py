"""The 4D-STraG training step in plain fp32: the flow-matching loss, its
gradient (each block run again in the backward, so a 9,568-token step
fits), the decaying global-norm clamp, AdamW and the EMA.

- sigma from the training schedule linspace(1, 1/1000, 1000) warped by
  shift 5; z_t = (1 - sigma) x + sigma noise, t = 1000 sigma, target
  noise - x; the loss is the mean of the squared error with errors over
  the threshold (50) masked out;
- the clamp: max norm 5 x 0.05 decaying linearly to 0.05 over 1000
  steps, the gradient scaled by min(1, max norm / its global norm);
- AdamW, decoupled: p (1 - lr wd), then m, v and the bias-corrected
  step lr m_hat / (sqrt(v_hat) + eps);
- EMA: e d + p (1 - d), from the starting weights.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import dit


def training_sigmas(train_steps: int, shift: float) -> np.ndarray:
    s = np.linspace(1.0, 1.0 / train_steps, train_steps)
    return (shift * s / (1 + (shift - 1) * s)).astype(np.float32)


def _run_block(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def loss_fn(params: Dict[str, Dict[str, torch.Tensor]], cfg, tr, batch,
            idx, noise, pr=dit.FP32):
    sig = torch.from_numpy(training_sigmas(tr["num_train_timesteps"],
                                           tr["shift"])).to(noise.device)
    sigma = sig[idx].reshape(-1, 1, 1, 1, 1)
    x = batch["x"]
    zt = (1 - sigma) * x + sigma * noise
    pred = dit.forward(lambda prefix: params[prefix], cfg, zt, batch["y"],
                       sigma.reshape(-1) * 1000.0, batch["context"],
                       batch["clip_fea"], batch["mpm_features"], pr,
                       run_block=_run_block)
    diff = pred - (noise - x)
    return (diff.square() * (diff.abs() <= tr["mse_threshold"])).mean()


def leaf_norms(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in ts])


def run_steps(make_group: Callable[[str], Dict[str, torch.Tensor]],
              prefixes: List[str], cfg, tr, batches, draws,
              pr=dit.FP32, start: Optional[dict] = None) -> dict:
    """Follow ``len(batches)`` steps, from the seeded weights
    (``make_group(prefix)`` gives each group's fp32 tensors) with empty
    moments at step 0, or from ``start``: {"step": the trainer's step,
    "adam_step": the optimizer's steps taken, "state": {name: (weights,
    first moment, second moment, EMA)}}, the program's state before the
    steps followed. Returns each step's loss, the names of the leaves,
    and per leaf: the first step's raw gradient norm and its norm as the
    optimizer got it (clamped), the norm of the weights' change and of
    the EMA's change over the steps."""
    dev = draws[0][1].device
    if start is None:
        groups = {pre: make_group(pre) for pre in prefixes}
        step0 = adam0 = 0
    else:
        groups = {pre: {} for pre in prefixes}
        for n, (p, _, _, _) in start["state"].items():
            pre = max((q for q in prefixes if n.startswith(q)), key=len)
            groups[pre][n[len(pre):]] = p.to(dev, torch.float32)
        step0, adam0 = start["step"], start["adam_step"]
    params = {pre: {k: v.clone().requires_grad_(True)
                    for k, v in groups[pre].items()} for pre in prefixes}
    del groups
    names = [pre + k for pre in prefixes for k in params[pre]]
    leaves = [params[pre][k] for pre in prefixes for k in params[pre]]
    p0 = [p.detach().clone() for p in leaves]
    if start is None:
        ema = [p.detach().clone() for p in leaves]
        m = [torch.zeros_like(p) for p in leaves]
        v = [torch.zeros_like(p) for p in leaves]
    else:
        state = [start["state"][n] for n in names]
        m, v, ema = ([s[j].to(dev, torch.float32) for s in state]
                     for j in (1, 2, 3))
    ema0 = [e.clone() for e in ema]
    lr, wd, eps = tr["learning_rate"], tr["weight_decay"], tr["adam_epsilon"]
    b1, b2 = tr["adam_betas"]
    out = {"loss": [], "names": names}
    for k, (batch, (idx, noise)) in enumerate(zip(batches, draws)):
        loss = loss_fn(params, cfg, tr, batch, idx, noise, pr)
        loss.backward()
        out["loss"].append(loss.item())
        with torch.no_grad():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in leaves]
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            # the clamp's linear decay (the trainer's steps stay within it)
            frac = min(max((step0 + k) / tr["grad_clip_decay_steps"], 0.0),
                       1.0)
            hi = tr["max_grad_norm"] * 5.0
            max_norm = hi + (tr["max_grad_norm"] - hi) * frac
            scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            if k == 0:
                out["grad_raw"] = leaf_norms(grads)
            grads = [g * scale for g in grads]
            if k == 0:
                out["grad"] = leaf_norms(grads)
            step = adam0 + k + 1
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for p, g, mi, vi, e in zip(leaves, grads, m, v, ema):
                p.mul_(1 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr / c1 * mi / (vi.sqrt() / c2 ** 0.5 + eps))
                e.mul_(tr["ema_decay"]).add_(p, alpha=1 - tr["ema_decay"])
                p.grad = None
    with torch.no_grad():
        out["change"] = leaf_norms([p - q for p, q in zip(leaves, p0)])
        out["ema_change"] = leaf_norms([e - q for e, q in zip(ema, ema0)])
    return out
