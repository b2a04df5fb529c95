"""Carry the JAX package's parameter trees across to the port.

Each function takes a flax parameter tree as nested dicts of arrays (numpy,
or anything ``np.asarray`` reads; the ``{"params": ...}`` wrapper optional)
and returns a ``state_dict`` for the port's module, keyed by the released
torch checkpoints' names, so the same dict loads with
``module.load_state_dict(sd, strict=True)``.

- Dense kernels [in, out] become Linear weights [out, in].
- Conv kernels [kt, kh, kw, in, out] / [kh, kw, in, out] become
  [out, in, kt, kh, kw] / [out, in, kh, kw].
- The DiT's scanned blocks (``blocks/block/...``, leading axis num_layers)
  are unstacked into ``blocks.{i}``. The fused-qkv path keeps separate
  q/k/v sub-trees in JAX, so it needs nothing special.
- VAE RMS-norm gammas (C,) take the released shapes (C,1,1,1), or (C,1,1)
  in the attention block.
- flax ConvTranspose kernels are flipped into torch's ConvTranspose2d
  weights (UniDepth's up1/up2).
- The towers (umT5, CLIP's vision tower, OmniMAE, UniDepth with its DINOv2
  backbone) take the names their JAX converters read, so a dict from here
  goes back through those converters to the same arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import CLIPVisionConfig, DiTConfig, T5Config, VAEConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(tree):
    return tree["params"] if "params" in tree else tree


def _dense(sd, key, p):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _conv(sd, key, p):
    k = np.asarray(p["kernel"])
    perm = (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
    sd[key + ".weight"] = _t(k.transpose(perm))
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _conv_transpose(sd, key, p):
    """flax ConvTranspose [kh, kw, in, out] -> torch ConvTranspose2d
    [in, out, kh, kw], spatially flipped (flax holds the correlation
    kernel, torch the convolution's gradient)."""
    k = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[key + ".weight"] = _t(k)
    sd[key + ".bias"] = _t(p["bias"])


def _norm(sd, key, p, scale="weight"):
    sd[key + ".weight"] = _t(p[scale])
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _dit_block(sd, key, p, cfg: DiTConfig):
    sd[key + ".modulation"] = _t(p["modulation"])
    for attn in ("self_attn", "cross_attn"):
        for name, sub in p[attn].items():
            if name.startswith("norm_"):
                _norm(sd, f"{key}.{attn}.{name}", sub)
            else:
                _dense(sd, f"{key}.{attn}.{name}", sub)
    if cfg.cross_attn_norm:
        _norm(sd, key + ".norm3", p["norm3"])
    _dense(sd, key + ".ffn.0", p["ffn"]["fc1"])
    _dense(sd, key + ".ffn.2", p["ffn"]["fc2"])
    if cfg.motion_guidance:
        for n in ("spatial_guidance_self", "spatial_guidance_ffn"):
            _dense(sd, f"{key}.{n}.spatial_guide.1", p[n]["spatial_guide"])
            sd[f"{key}.{n}.gate"] = _t(p[n]["gate"])


def dit_state_dict(tree, cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """JAX ``WanDiT`` params -> the port's ``WanDiT`` state dict."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embedding", p["patch_embedding"])
    for jax_name, key in (("text_fc1", "text_embedding.0"),
                          ("text_fc2", "text_embedding.2"),
                          ("time_fc1", "time_embedding.0"),
                          ("time_fc2", "time_embedding.2"),
                          ("time_proj", "time_projection.1")):
        _dense(sd, key, p[jax_name])
    if cfg.model_type == "i2v":
        _norm(sd, "img_emb.proj.0", p["img_ln_in"], "scale")
        _dense(sd, "img_emb.proj.1", p["img_fc1"])
        _dense(sd, "img_emb.proj.3", p["img_fc2"])
        _norm(sd, "img_emb.proj.4", p["img_ln_out"], "scale")
    for jax_name, key in (("control_adapter_conv", "control_adapter"),
                          ("ref_conv_layer", "ref_conv"),
                          ("feature_adapter_1", "feature_adapter.0"),
                          ("feature_adapter_2", "feature_adapter.2")):
        if jax_name in p:
            _conv(sd, key, p[jax_name])
    for i in range(cfg.num_layers):
        if "blocks" in p:
            blk = _index_tree(p["blocks"]["block"], i)
        else:
            blk = p[f"blocks_{i}"]
        _dit_block(sd, f"blocks.{i}", blk, cfg)
    sd["head.modulation"] = _t(p["head"]["modulation"])
    _dense(sd, "head.head", p["head"]["head"])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _vae_gamma(sd, key, p, images=False):
    g = np.asarray(p["gamma"]).reshape((-1, 1, 1) if images
                                       else (-1, 1, 1, 1))
    sd[key + ".gamma"] = _t(g)


def _vae_res(sd, key, p):
    _vae_gamma(sd, key + ".residual.0", p["norm1"])
    _conv(sd, key + ".residual.2", p["conv1"]["conv"])
    _vae_gamma(sd, key + ".residual.3", p["norm2"])
    _conv(sd, key + ".residual.6", p["conv2"]["conv"])
    if "shortcut" in p:
        _conv(sd, key + ".shortcut", p["shortcut"]["conv"])


def _vae_coder(sd, prefix, p, seq, name):
    _conv(sd, prefix + ".conv1", p["conv1"]["conv"])
    idx = 0
    while f"{name}_{idx}" in p or f"{name}_{idx}_s" in p:
        key = f"{prefix}.{seq}.{idx}"
        if f"{name}_{idx}_s" in p:                 # a resample layer
            _conv(sd, key + ".resample.1", p[f"{name}_{idx}_s"]["conv"])
            if f"{name}_{idx}" in p:
                _conv(sd, key + ".time_conv", p[f"{name}_{idx}"]["time_conv"])
        else:
            _vae_res(sd, key, p[f"{name}_{idx}"])
        idx += 1
    _vae_res(sd, prefix + ".middle.0", p["mid_res1"])
    attn = p["mid_attn"]
    _vae_gamma(sd, prefix + ".middle.1.norm", attn["norm"], images=True)
    _conv(sd, prefix + ".middle.1.to_qkv", attn["to_qkv"])
    _conv(sd, prefix + ".middle.1.proj", attn["proj"])
    _vae_res(sd, prefix + ".middle.2", p["mid_res2"])
    _vae_gamma(sd, prefix + ".head.0", p["head_norm"])
    _conv(sd, prefix + ".head.2", p["head_conv"]["conv"])


def vae_state_dict(tree, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """JAX ``WanVAE`` params -> the port's ``WanVAE`` state dict (the
    released ``Wan2.1_VAE.pth`` key layout)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    _vae_coder(sd, "encoder", p["encoder"], "downsamples", "down")
    _vae_coder(sd, "decoder", p["decoder"], "upsamples", "up")
    _conv(sd, "conv1", p["conv1"]["conv"])
    _conv(sd, "conv2", p["conv2"]["conv"])
    return sd


def adaptor_state_dict(tree, decoder: bool) -> Dict[str, torch.Tensor]:
    """JAX ``VAEDecoderAdaptor``/``VAEEncoderAdaptor`` params -> the port's
    state dict."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    stage = "up" if decoder else "down"
    _conv(sd, "conv_in", p["conv_in"])
    i = 0
    while f"block_{i}" in p:
        blk, key = p[f"block_{i}"], f"{stage}.0.block.{i}"
        for n in ("norm1", "norm2"):
            _norm(sd, f"{key}.{n}", blk[n], "scale")
        for n in ("conv1", "conv2"):
            _conv(sd, f"{key}.{n}", blk[n])
        i += 1
    _norm(sd, "norm_out", p["norm_out"], "scale")
    _conv(sd, "conv_out", p["conv_out"])
    return sd


def t5_state_dict(tree, cfg: T5Config) -> Dict[str, torch.Tensor]:
    """JAX ``WanT5Encoder`` params -> the port's ``WanT5Encoder`` state
    dict (the released umT5 checkpoint's names)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {
        "token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        "norm.weight": _t(p["norm"]["weight"])}
    if cfg.shared_pos:
        sd["pos_embedding.embedding.weight"] = _t(
            p["pos_embedding"]["embedding"])
    for i in range(cfg.num_layers):
        blk, key = p[f"blocks_{i}"], f"blocks.{i}"
        for n in ("norm1", "norm2"):
            sd[f"{key}.{n}.weight"] = _t(blk[n]["weight"])
        for n in "qkvo":
            _dense(sd, f"{key}.attn.{n}", blk["attn"][n])
        _dense(sd, key + ".ffn.gate.0", blk["ffn"]["gate"])
        _dense(sd, key + ".ffn.fc1", blk["ffn"]["fc1"])
        _dense(sd, key + ".ffn.fc2", blk["ffn"]["fc2"])
        if not cfg.shared_pos:
            sd[key + ".pos_embedding.embedding.weight"] = _t(
                blk["pos_embedding"]["embedding"])
    return sd


def clip_vision_state_dict(tree, cfg: CLIPVisionConfig
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``ClipVisionTower`` params -> the port's ``ClipVisionTower``
    state dict (the reference's ``visual.`` names without the prefix)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {
        "cls_embedding": _t(p["cls_embedding"]),
        "pos_embedding": _t(p["pos_embedding"])}
    _conv(sd, "patch_embedding", p["patch_embedding"])
    _norm(sd, "pre_norm", p["pre_norm"]["LayerNorm_0"], "scale")
    for i in range(cfg.num_layers - 1):
        blk, key = p[f"blocks_{i}"], f"transformer.{i}"
        _norm(sd, key + ".norm1", blk["norm1"]["LayerNorm_0"], "scale")
        _dense(sd, key + ".attn.to_qkv", blk["to_qkv"])
        _dense(sd, key + ".attn.proj", blk["attn_proj"])
        _norm(sd, key + ".norm2", blk["norm2"]["LayerNorm_0"], "scale")
        _dense(sd, key + ".mlp.0", blk["mlp_fc1"])
        _dense(sd, key + ".mlp.2", blk["mlp_fc2"])
    return sd


def _vit_block(sd, key, blk):
    _norm(sd, key + ".norm1", blk["norm1"], "scale")
    _dense(sd, key + ".attn.qkv", blk["qkv"])
    _dense(sd, key + ".attn.proj", blk["attn_proj"])
    _norm(sd, key + ".norm2", blk["norm2"], "scale")
    _dense(sd, key + ".mlp.fc1", blk["mlp_fc1"])
    _dense(sd, key + ".mlp.fc2", blk["mlp_fc2"])


def omnimae_state_dict(tree, depth: int = 12) -> Dict[str, torch.Tensor]:
    """JAX ``OmniMAEViT`` params -> the port's ``OmniMAEViT`` state dict
    (the reference trunk's names)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embed.proj.1", p["patch_proj"])
    _norm(sd, "norm", p["norm"], "scale")
    for i in range(depth):
        _vit_block(sd, f"blocks.{i}", p[f"blocks_{i}"])
    return sd


def dinov2_state_dict(tree, depth: int = 24) -> Dict[str, torch.Tensor]:
    """JAX ``DinoV2ViT`` params -> the port's ``DinoV2ViT`` state dict
    (the official dinov2 names)."""
    p = _params(tree)
    sd: Dict[str, torch.Tensor] = {"cls_token": _t(p["cls_token"]),
                                   "pos_embed": _t(p["pos_embed"])}
    _conv(sd, "patch_embed.proj", p["patch_proj"])
    _norm(sd, "norm", p["norm"], "scale")
    for i in range(depth):
        blk, key = p[f"blocks_{i}"], f"blocks.{i}"
        _vit_block(sd, key, blk)
        sd[key + ".ls1.gamma"] = _t(blk["ls1"])
        sd[key + ".ls2.gamma"] = _t(blk["ls2"])
    return sd


def _cross_block(sd, key, blk):
    for n in ("norm1", "norm_ctx", "norm2"):
        _norm(sd, f"{key}.{n}", blk[n], "scale")
    for n in ("q", "k", "v", "proj", "fc1", "fc2"):
        _dense(sd, f"{key}.{n}", blk[n])


def unidepth_state_dict(tree, backbone_depth: int = 24
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``UniDepthV2`` params -> the port's ``UniDepthV2`` state dict:
    ``pixel_encoder.`` plus the dinov2 names, and the decoder names of the
    JAX package's ``unidepth_decoder_key_manifest``."""
    p = _params(tree)
    sd = {"pixel_encoder." + k: v for k, v in
          dinov2_state_dict(p["pixel_encoder"], backbone_depth).items()}
    i = 0
    while f"input_adapter_{i}" in p:
        _dense(sd, f"input_adapters.{i}", p[f"input_adapter_{i}"])
        i += 1
    cam, dep = p["camera_head"], p["depth_head"]
    sd["camera_head.camera_tokens"] = _t(cam["camera_tokens"])
    _norm(sd, "camera_head.norm", cam["norm"], "scale")
    _dense(sd, "camera_head.proj", cam["proj"])
    _dense(sd, "depth_head.ray_proj", dep["ray_proj"])
    _norm(sd, "depth_head.norm", dep["norm"], "scale")
    _conv_transpose(sd, "depth_head.up1", dep["up1"])
    _conv_transpose(sd, "depth_head.up2", dep["up2"])
    _conv(sd, "depth_head.out", dep["out"])
    for head, sub in (("camera_head", cam), ("depth_head", dep)):
        i = 0
        while f"blocks_{i}" in sub:
            _cross_block(sd, f"{head}.blocks.{i}", sub[f"blocks_{i}"])
            i += 1
    return sd


def _lora_weight_name(path: str, layer: int, t5: bool = False) -> str:
    """A JAX LoRA factor path (``params/blocks/block/ffn/fc1/kernel`` or
    ``params/blocks_3/self_attn/q/kernel``) -> the port's weight name
    (``blocks.3.ffn.0.weight``). With ``t5``, an umT5 path
    (``params/blocks_3/ffn/gate/kernel``) -> ``blocks.3.ffn.gate.0.weight``
    (its attention and fc1/fc2 keep their names)."""
    inner = path.split("blocks/block/")[-1] if "blocks/block/" in path \
        else path.split("/", 2)[-1]
    inner = inner[:-len("/kernel")]
    if t5:
        inner = inner.replace("ffn/gate", "ffn/gate/0")
    else:
        inner = inner.replace("ffn/fc1", "ffn/0").replace("ffn/fc2", "ffn/2")
    return f"blocks.{layer}.{inner.replace('/', '.')}.weight"


def lora_factors(lora, t5: bool = False) -> Dict[str, object]:
    """A JAX LoRA (``{'rank', 'alpha', 'factors'}`` of
    ``more4d_tpu.train.lora``, scanned [L, in, r] / [L, r, out] stacks or
    per-block [in, r] / [r, out]) -> the port's LoRA: the same rank and
    alpha, factors keyed by weight name in torch layout (down [r, in], up
    [out, r]), as ``more4d_tpu_torch.train.lora`` holds them. ``t5``: the
    LoRA is of the umT5 tower (``TE_LORA_TARGETS``), not the DiT."""
    factors = {}
    for path, f in lora["factors"].items():
        down, up = np.asarray(f["down"]), np.asarray(f["up"])
        if down.ndim == 3:
            for i in range(down.shape[0]):
                factors[_lora_weight_name(path, i, t5)] = {
                    "down": _t(down[i].T), "up": _t(up[i].T)}
        else:
            layer = int(path.split("/")[1][len("blocks_"):])
            factors[_lora_weight_name(path, layer, t5)] = {
                "down": _t(down.T), "up": _t(up.T)}
    return {"rank": int(np.asarray(lora["rank"])),
            "alpha": float(np.asarray(lora["alpha"])), "factors": factors}
