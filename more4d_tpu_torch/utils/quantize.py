"""fp8 weight storage for the DiT (PyTorch port of
``more4d_tpu/utils/quantize.py``).

``quantize_params_fp8`` turns a built ``WanDiT`` into fp8 storage in
place: each eligible tensor becomes a ``float8_e4m3fn`` tensor (with a
float32 ``<name>_scale`` buffer beside it when ``scaled``), and its layer
widens it to the compute dtype on each call (``nn.layers.compute_param``),
as flax promotes the JAX package's fp8 kernels inside the graph.

Which tensors are eligible is the JAX rule read on the JAX parameter tree
(``jax_param``). The two packages name the same tensors differently, and
the rule is a substring test: JAX's ``text_fc1`` is the port's
``text_embedding.0``, so the port's name would keep it in bf16. And the
JAX package scans its blocks: each block tensor is a slice of one leaf
stacked over the layers, one rank higher, so the rank test passes block
biases and FiLM gates too, and a scaled cast takes one scale across the
layers. (Per-layer host blocks, ``parallel/offload.py``, keep those in
bf16, as the JAX package's do.)

The cast is torch's round-to-nearest-even, the JAX package's bits for
every value up to 464; above that torch saturates to 448 where JAX gives
NaN (the reference's torch code saturates too).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0  # float8_e4m3fn max normal

# the port's DiT modules that the JAX package names otherwise (its blocks
# hold the same words, so a block path needs no renaming)
_JAX_MODULES = {
    "text_embedding.0": "text_fc1", "text_embedding.2": "text_fc2",
    "time_embedding.0": "time_fc1", "time_embedding.2": "time_fc2",
    "time_projection.1": "time_proj", "img_emb.proj.0": "img_ln_in",
    "img_emb.proj.1": "img_fc1", "img_emb.proj.3": "img_fc2",
    "img_emb.proj.4": "img_ln_out", "control_adapter": "control_adapter_conv",
    "ref_conv": "ref_conv_layer", "feature_adapter.0": "feature_adapter_1",
    "feature_adapter.2": "feature_adapter_2",
}


def jax_param(name: str, tensor: torch.Tensor) -> Tuple[str, int]:
    """A port DiT parameter -> (its JAX parameter path, its rank there):
    ``text_embedding.0.weight`` -> (``params/text_fc1/weight``, 2);
    ``blocks.3.self_attn.q.bias`` -> (``params/blocks/block/self_attn/q/
    bias``, 2), the scanned stack's leaf."""
    if name.startswith("blocks."):
        rest = name.split(".", 2)[2]
        return ("params/blocks/block/" + rest.replace(".", "/"),
                tensor.dim() + 1)
    module, leaf = name.rsplit(".", 1)
    module = _JAX_MODULES.get(module, module)
    return f"params/{module}/{leaf}".replace(".", "/"), tensor.dim()


def cast_float_leaves(state_dict: Dict[str, torch.Tensor], dtype
                      ) -> Dict[str, torch.Tensor]:
    """Every floating tensor of a state dict cast to ``dtype`` (the
    reference's ``.to(weight_dtype)``); ``dtype`` None returns it as is."""
    if dtype is None:
        return state_dict
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in state_dict.items()}


def _should_quantize(path: str, ndim: int) -> bool:
    """The JAX rule on a leaf's path and rank: matrices and conv kernels
    only; norms, modulation tables and embeddings stay in high
    precision."""
    if ndim < 2:
        return False
    return not any(k in path.lower()
                   for k in ("norm", "modulation", "embedding"))


@torch.no_grad()
def quantize_params_fp8(model: nn.Module, scaled: bool = True) -> nn.Module:
    """``model`` (a ``WanDiT``) with every eligible tensor stored in fp8,
    in place, and returned. Scaled: x / scale with scale = max(max|x| /
    448, 1e-12) in float32 over the JAX leaf (one scale for a block
    tensor's slices in every layer). Each JAX leaf's tensors are replaced
    together, so the wider copies go leaf by leaf."""
    leaves: Dict[str, list] = {}
    for full, p in model.named_parameters():
        path, ndim = jax_param(full, p)
        if _should_quantize(path, ndim):
            owner, attr = full.rsplit(".", 1)
            leaves.setdefault(path, []).append(
                (model.get_submodule(owner), attr, p))
    for path in list(leaves):
        members = leaves.pop(path)
        scale = None
        if scaled:
            amax = torch.stack([p.float().abs().max()
                                for _, _, p in members]).max()
            scale = torch.clamp_min(amax / FP8_MAX, 1e-12)
        for module, attr, p in members:
            q = p.to(FP8) if scale is None else (p.float() / scale).to(FP8)
            setattr(module, attr, nn.Parameter(q, requires_grad=False))
            if scale is not None:
                module.register_buffer(attr + "_scale", scale.clone())
    return model


@torch.no_grad()
def dequantize_params(model: nn.Module, dtype=torch.bfloat16
                      ) -> Dict[str, torch.Tensor]:
    """The state dict of a quantized ``model`` with its fp8 tensors back in
    ``dtype``: a scaled one as (fp8 in float32 x scale) in ``dtype``, an
    unscaled one cast; the scales dropped, the rest as it is."""
    sd = model.state_dict()
    out = {}
    for k, v in sd.items():
        if k.endswith("_scale") and k[:-len("_scale")] in sd:
            continue
        if v.dtype == FP8:
            scale = sd.get(k + "_scale")
            v = (v.float() * scale).to(dtype) if scale is not None \
                else v.to(dtype)
        out[k] = v
    return out
