"""LoRA factors and their merge (PyTorch port of
``more4d_tpu/train/lora.py``).

The reference puts a LoRA on every Linear inside the DiT blocks (rank 4,
alpha 1 by default): W' = W + multiplier * (alpha / rank) * up @ down. Here
a LoRA is ``{'rank', 'alpha', 'factors'}`` with the factors keyed by the
weight they change, in torch layout: ``{'blocks.3.self_attn.q.weight':
{'down': [r, in], 'up': [out, r]}}``. ``apply_lora`` is the merge used at
inference.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

# every Linear weight inside the blocks (self and cross attention, FFN)
DEFAULT_TARGETS = r"^blocks\.\d+\.(self_attn|cross_attn|ffn)\..*weight$"


def create_lora(state_dict: Dict[str, torch.Tensor],
                generator: torch.Generator, rank: int = 4,
                alpha: float = 1.0, targets: str = DEFAULT_TARGETS,
                skip_name: Optional[str] = None):
    """Factors for every 2-D weight of ``state_dict`` whose name matches
    ``targets`` and does not contain ``skip_name``: down kaiming-uniform
    (bound sqrt(6 / in)) drawn from ``generator`` in name order, up zero,
    so the LoRA starts as the identity. Factors are float32 on the
    generator's device."""
    pattern = re.compile(targets)
    factors = {}
    for name in sorted(state_dict):
        w = state_dict[name]
        if not (pattern.search(name) and w.dim() == 2):
            continue
        if skip_name is not None and skip_name in name:
            continue
        out_dim, in_dim = w.shape
        bound = (6.0 / in_dim) ** 0.5
        down = torch.empty(rank, in_dim, device=generator.device)
        factors[name] = {
            "down": down.uniform_(-bound, bound, generator=generator),
            "up": torch.zeros(out_dim, rank, device=generator.device)}
    return {"rank": rank, "alpha": alpha, "factors": factors}


@torch.no_grad()
def apply_lora(state_dict: Dict[str, torch.Tensor], lora,
               multiplier: float = 1.0) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every LoRA'd weight merged: W + multiplier *
    (alpha / rank) * up @ down, computed in float32 and stored back in W's
    dtype (so merge before casting to bf16, as the CLI does). The other
    entries are the same tensors."""
    scale = multiplier * lora["alpha"] / lora["rank"]
    out = dict(state_dict)
    for name, f in lora["factors"].items():
        if name not in out:
            raise KeyError(f"LoRA factor for {name}, which the model does "
                           f"not hold")
        w = out[name]
        delta = f["up"].float().to(w.device) @ f["down"].float().to(w.device)
        out[name] = (w.float() + scale * delta).to(w.dtype)
    return out


def lora_param_count(lora) -> int:
    return sum(v.numel() for f in lora["factors"].values()
               for v in f.values())
