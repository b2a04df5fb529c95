"""The 4D-ViSM LoRA fine-tune step of the InP DiT streamed from host
memory, in plain fp32: the LoRA's factors drawn from the seed, the frozen
base in its streamed storage, the thresholded flow-matching loss, the
factors' gradients, the global-norm clip and AdamW.

- the frozen weights are held no wider than the streamed configuration
  stores them (``stream.stored_streamed``: a block's Linear weight
  matrices as float8_e4m3fn, rounded from bf16 by ``fp8.round_e4m3``;
  the rest of a block bf16; the parts outside the blocks fp32 holding
  bf16 values) and widened to fp32 inside each block's function; each
  block runs under a checkpoint, so a 9,568-token step at 14B fits (its
  base in fp32 would be 65.6 GB);
- the forward is ``dit.py``'s (``embed``, ``block``, ``head``) without
  motion guidance;
- sigma from ``train.training_sigmas`` (shift 5), z_t = (1 - sigma) x +
  sigma noise, t = 1000 sigma, target noise - x; the loss is the mean of
  the squared error with errors over the threshold (50) masked out;
- the clip: the gradients scaled by max_norm / norm where their global
  norm is max_norm or more;
- AdamW, decoupled: p (1 - lr wd), then m, v and the bias-corrected step
  lr m_hat / (sqrt(v_hat) + eps).

Departure from the program: the program adds each LoRA as a side path
to its Linear's output, x W^T + s (x down^T) up^T; here each block's
function merges W + s up down before ``dit.block`` runs, the same product
in another order (exact in real arithmetic).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from h100_bench import inputs
from h100_bench.reference import dit
from h100_bench.reference.fp8 import round_e4m3
from h100_bench.reference.stream import stored_streamed
from h100_bench.reference.train import leaf_norms, training_sigmas

# a frozen copy of the program's targets (``train/lora.py
# DEFAULT_TARGETS``): every weight matrix of a block's attentions and
# feed-forward
TARGETS = ("self_attn.", "cross_attn.", "ffn.")
FACTOR_TAG = 500

Factors = Dict[str, Dict[str, torch.Tensor]]


def scale(cfg) -> float:
    """The side path's multiplier: alpha / rank (the multiplier 1)."""
    return cfg["lora_alpha"] / cfg["lora_rank"]


def targets(cfg) -> Dict[int, List[tuple]]:
    """{layer: [(weight name, out, in)]} of the factored weights, each
    block's in name order."""
    spec = sorted((n, s) for n, s, _, _ in inputs.block_spec(cfg)
                  if len(s) == 2 and n.startswith(TARGETS)
                  and n.endswith("weight"))
    return {i: [(f"blocks.{i}.{n}", s[0], s[1]) for n, s in spec]
            for i in range(cfg["num_layers"])}


def leaf_names(cfg) -> List[str]:
    """The factors' names in the program's order (``train_vism.py
    factor_leaves``): each weight's down, then up, by weight name."""
    names = sorted(n for ws in targets(cfg).values() for n, _, _ in ws)
    return [f"{n}.{k}" for n in names for k in ("down", "up")]


@torch.no_grad()
def factors(cfg, seed: int, device) -> Factors:
    """{weight name: {'down': [r, in], 'up': [out, r]}} in fp32, drawn a
    block at a time from a generator seeded by (seed, block): down
    uniform in +-sqrt(6 / in) (the program's ``create_lora``), up
    N(0, s^2) with s = lora_side_share / (scale sqrt(2 r)), so that the
    side path's output is about ``lora_side_share`` of its Linear's (down
    spreads an input row of unit scale to sqrt(2) a rank, up sums r of
    them)."""
    r = cfg["lora_rank"]
    std = cfg["lora_side_share"] / (scale(cfg) * math.sqrt(2 * r))
    out: Factors = {}
    for i, ws in targets(cfg).items():
        g = torch.Generator(device).manual_seed(
            inputs.mix(seed, FACTOR_TAG + i))
        for name, n_out, n_in in ws:
            bound = math.sqrt(6.0 / n_in)
            down = torch.rand(r, n_in, generator=g, device=device) \
                .mul_(2 * bound).sub_(bound)
            up = torch.randn(n_out, r, generator=g, device=device).mul_(std)
            out[name] = {"down": down, "up": up}
    return out


@torch.no_grad()
def stored(cfg, seed: int, device):
    """(the top group's fp32 tensors, each block's tensors as the streamed
    configuration stores them: float8_e4m3fn where ``stored_streamed``
    says so, else bf16), made again from the seed a group at a time."""
    make, prefixes = inputs.group_maker(cfg, seed, torch.bfloat16, device)
    top = {k: v.float() for k, v in make("").items()}
    blocks = []
    for prefix in prefixes[1:]:
        # each tensor its own copy: a group's tensors are views of one
        # draw, which a view kept would hold whole
        blocks.append({k: round_e4m3(v.float()).to(torch.float8_e4m3fn)
                       if stored_streamed(prefix + k) else v.clone()
                       for k, v in make(prefix).items()})
    return top, blocks


def _block(held, merged, s, cfg, x, e0, ctx, cos, sin, pr):
    """One block from its held tensors, widened to fp32, with ``merged``
    {name in the block: (down, up)} merged as W + s up down."""
    p = {k: v.float() for k, v in held.items()}
    for k, (down, up) in merged.items():
        p[k] = p[k] + s * (up @ down)
    return dit.block(p, cfg, x, e0, ctx, cos, sin, None, pr)


def loss(top, blocks, fac: Dict[str, tuple], cfg, tr, batch, idx, noise,
         pr=dit.FP32):
    """The thresholded flow-matching loss of one batch, each block run
    under a checkpoint. ``fac``: {weight name: (down, up)}."""
    sig = torch.from_numpy(training_sigmas(tr["num_train_timesteps"],
                                           tr["shift"])).to(noise.device)
    sigma = sig[idx].reshape(-1, 1, 1, 1, 1)
    x = batch["latents"]
    zt = (1 - sigma) * x + sigma * noise
    tokens, e, e0, ctx, _, grid = dit.embed(
        top, cfg, zt, batch["y"], sigma.reshape(-1) * 1000.0,
        batch["context"], batch["clip_fea"], None, pr)
    cos, sin = dit.rope_tables(cfg["dim"] // cfg["num_heads"], grid,
                               x.device)
    s = scale(cfg)
    for i, held in enumerate(blocks):
        pre = f"blocks.{i}."
        merged = {n[len(pre):]: f for n, f in fac.items()
                  if n.startswith(pre)}
        tokens = checkpoint(_block, held, merged, s, cfg, tokens, e0, ctx,
                            cos, sin, pr, use_reentrant=False)
    diff = dit.head(top, cfg, tokens, e, grid, pr) - (noise - x)
    return (diff.square() * (diff.abs() <= tr["mse_threshold"])).mean()


def run_steps(top, blocks, fac0: Factors, cfg, tr, batches, draws,
              pr=dit.FP32, start: Optional[dict] = None) -> dict:
    """Follow ``len(batches)`` steps from the seeded factors ``fac0`` with
    empty moments, or from ``start``: {"adam_step": the optimizer's steps
    taken, "state": {leaf name: (factor, first moment, second moment)}},
    the program's state before the steps followed. Returns the names of
    the leaves (``leaf_names``), each step's loss, and per leaf the first
    step's gradient norm before and after the clip and the norm of its
    change over the steps."""
    dev = draws[0][1].device
    names = leaf_names(cfg)
    weights = [n.rsplit(".", 1)[0] for n in names[0::2]]
    if start is None:
        leaves = [fac0[w][k].clone() for w in weights for k in ("down", "up")]
        m = [torch.zeros_like(p) for p in leaves]
        v = [torch.zeros_like(p) for p in leaves]
        adam0 = 0
    else:
        state = [start["state"][n] for n in names]
        leaves, m, v = ([s[j].to(dev, torch.float32) for s in state]
                        for j in range(3))
        adam0 = start["adam_step"]
    leaves = [p.requires_grad_(True) for p in leaves]
    p0 = [p.detach().clone() for p in leaves]
    lr, wd, eps = tr["learning_rate"], tr["weight_decay"], tr["adam_epsilon"]
    b1, b2 = tr["adam_betas"]
    max_norm = tr["max_grad_norm"]
    out = {"names": names, "loss": []}
    for k, (batch, (idx, noise)) in enumerate(zip(batches, draws)):
        fac = {w: (leaves[2 * j], leaves[2 * j + 1])
               for j, w in enumerate(weights)}
        value = loss(top, blocks, fac, cfg, tr, batch, idx, noise, pr)
        grads = torch.autograd.grad(value, leaves)
        out["loss"].append(value.item())
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if k == 0:
                out["grad_raw"] = leaf_norms(grads).tolist()
            if norm >= max_norm:
                grads = [g / norm * max_norm for g in grads]
            if k == 0:
                out["grad"] = leaf_norms(grads).tolist()
            step = adam0 + k + 1
            c1, c2 = 1 - b1 ** step, 1 - b2 ** step
            for p, g, mi, vi in zip(leaves, grads, m, v):
                p.mul_(1 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                p.sub_(lr / c1 * mi / (vi.sqrt() / c2 ** 0.5 + eps))
    out["change"] = leaf_norms([p - q for p, q in zip(leaves, p0)]).tolist()
    return out
