"""Kohya-style LoRA checkpoints <-> the port's LoRA (PyTorch port of
``more4d_tpu/convert/lora_torch.py``).

The reference saves its ViSM LoRA with kohya names:
``lora_unet_blocks_<i>_<module>.lora_down.weight`` [r, in],
``.lora_up.weight`` [out, r] and ``.alpha``, module ``self_attn_q``,
``cross_attn_k_img``, ``ffn_0``, ... The port's factors are keyed by the
weight they change (``blocks.<i>.self_attn.q.weight``) in the same torch
layout. As in the JAX converter, a file's LoRA has one alpha: the last one
read.
"""

from __future__ import annotations

import os
import re

import torch

from ..train.checkpoint import CheckpointManager, refuse_orbax
from ..utils.safetensors_io import load_file, save_file

_KOHYA = re.compile(r"^blocks_(\d+)_(self_attn|cross_attn|ffn)_(.+)$")


def convert_kohya_lora(sd, prefix: str = "lora_unet_"):
    """Kohya state dict (tensors or arrays) -> ``{'rank', 'alpha',
    'factors'}`` with float32 factors; keys outside the blocks are
    skipped, as the JAX converter skips them."""
    pat = re.compile(rf"^{re.escape(prefix)}(blocks_\d+_.+)\.lora_down"
                     rf"\.weight$")
    factors, rank, alpha = {}, None, 1.0
    for k in sd:
        m = pat.match(k)
        if not m:
            continue
        base = k[:-len(".lora_down.weight")]
        km = _KOHYA.match(m.group(1))
        if km is None:
            raise ValueError(f"kohya LoRA key {k}: not a self_attn, "
                             f"cross_attn or ffn module of a block")
        i, group, mod = km.groups()
        down = torch.as_tensor(sd[k]).float()
        if base + ".alpha" in sd:
            alpha = float(torch.as_tensor(sd[base + ".alpha"]))
        rank = down.shape[0]
        factors[f"blocks.{i}.{group}.{mod}.weight"] = {
            "down": down,
            "up": torch.as_tensor(sd[base + ".lora_up.weight"]).float()}
    return {"rank": rank or 4, "alpha": alpha, "factors": factors}


def export_kohya_lora(lora, prefix: str = "lora_unet_"):
    """The inverse of ``convert_kohya_lora``: the port's LoRA -> a kohya
    state dict of float32 tensors (every module with the LoRA's alpha),
    which the reference's merge reads."""
    sd = {}
    alpha = torch.tensor(float(lora["alpha"]), dtype=torch.float32)
    for name, f in lora["factors"].items():
        _, i, group, *mod, _ = name.split(".")
        base = f"{prefix}blocks_{i}_{group}_{'_'.join(mod)}"
        sd[base + ".lora_down.weight"] = f["down"].float()
        sd[base + ".lora_up.weight"] = f["up"].float()
        sd[base + ".alpha"] = alpha
    return sd


def save_kohya_lora(path: str, lora) -> None:
    """Write the exported kohya state dict as ``.safetensors``."""
    save_file(export_kohya_lora(lora), path)


def load_vism_lora(path: str):
    """A LoRA to merge: a kohya checkpoint (``.safetensors``, or a torch
    file) or a checkpoint directory of the port's trainers
    (``train/checkpoint.py``) whose params are the LoRA itself (of which
    only the DiT factors, ``dit``, when it also holds text-encoder
    factors)."""
    if os.path.isdir(path):
        refuse_orbax(path)
        lora = CheckpointManager(path).restore_params()
        if "dit" in lora and "te" in lora:
            print("NOTE: checkpoint carries text-encoder LoRA factors; "
                  "only the DiT factors are merged at inference")
            lora = lora["dit"]
        return {"rank": int(lora["rank"]), "alpha": float(lora["alpha"]),
                "factors": lora["factors"]}
    if path.endswith(".safetensors"):
        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_kohya_lora(sd)
