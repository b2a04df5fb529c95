"""Released Wan DiT checkpoints -> the port's ``WanDiT`` state dict
(PyTorch port of ``more4d_tpu/convert/dit_torch.py``).

A ``WanTransformer3D/4DModel`` state dict (the ``diffusion_pytorch_model*
.safetensors`` shards of the Wan2.1-Fun releases, a single
``.safetensors``, or a ``.pth``) already carries the names the port's
``WanDiT`` holds, so converting is checking and checkpoint surgery, as the
JAX converter does it:

- a 48-channel Control checkpoint loads into the 4D config (in_dim 64) with
  its patch embedding zero-padded on the new input channels (a wider one is
  cut);
- 4D additions absent from a 3D checkpoint are initialised fresh: the FiLM
  modules (``spatial_guidance_*``) to exact zeros, the ``ref_conv`` and
  ``feature_adapter`` convs xavier-uniform from ``np.random.RandomState(
  seed)`` drawn in the JAX converter's order (``ref_conv``, then
  ``feature_adapter.0``, then ``feature_adapter.2``), so they are the JAX
  package's bits;
- keys under ``omnimae_extractor.`` (the frozen OmniMAE trunk a 4D
  checkpoint embeds) belong to the OmniMAE builder and are left out.

Every tensor is cast to the caller's dtype (float32 by default, the JAX
converter's) as it is read.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import DiTConfig
from ..train.checkpoint import CheckpointManager, refuse_orbax
from ..utils.safetensors_io import load_file

OMNIMAE_PREFIX = "omnimae_extractor."


def wan_dit_key_manifest(cfg: DiTConfig) -> Tuple[List[str],
                                                  Dict[str, List[str]]]:
    """The exact key set of a reference WanTransformer3D/4D state dict at
    this config: ``(required, optional_groups)``. Every required key must
    be present; each optional group (name -> keys) is all or nothing, and
    an absent group is initialised fresh."""
    def wb(p):
        return [p + ".weight", p + ".bias"]

    req = (wb("patch_embedding") + wb("text_embedding.0")
           + wb("text_embedding.2") + wb("time_embedding.0")
           + wb("time_embedding.2") + wb("time_projection.1")
           + ["head.modulation"] + wb("head.head"))
    if cfg.model_type == "i2v":
        for i in (0, 1, 3, 4):
            req += wb(f"img_emb.proj.{i}")
    sg = []
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        req.append(f"{b}.modulation")
        for a in ("self_attn", "cross_attn"):
            for m in ("q", "k", "v", "o"):
                req += wb(f"{b}.{a}.{m}")
            if cfg.qk_norm:
                req += [f"{b}.{a}.norm_q.weight", f"{b}.{a}.norm_k.weight"]
        if cfg.model_type == "i2v":
            req += wb(f"{b}.cross_attn.k_img") + wb(f"{b}.cross_attn.v_img")
            if cfg.qk_norm:
                req.append(f"{b}.cross_attn.norm_k_img.weight")
        if cfg.cross_attn_norm:
            req += wb(f"{b}.norm3")
        req += wb(f"{b}.ffn.0") + wb(f"{b}.ffn.2")
        if cfg.motion_guidance:
            for n in ("spatial_guidance_self", "spatial_guidance_ffn"):
                sg += wb(f"{b}.{n}.spatial_guide.1") + [f"{b}.{n}.gate"]
    opt = {}
    if cfg.motion_guidance:
        opt["spatial_guidance"] = sg
        opt["feature_adapter"] = wb("feature_adapter.0") + wb(
            "feature_adapter.2")
    if cfg.ref_conv:
        opt["ref_conv"] = wb("ref_conv")
    return req, opt


def _xavier_conv(rs: np.random.RandomState, kh: int, kw: int, cin: int,
                 cout: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """xavier-uniform conv weight [cout, cin, kh, kw] and zero bias, drawn
    in the JAX converter's HWIO order."""
    fan_in, fan_out = kh * kw * cin, kh * kw * cout
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    w = rs.uniform(-limit, limit, (kh, kw, cin, cout)).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            torch.zeros(cout))


def _patch_embed_surgery(w: torch.Tensor, cfg: DiTConfig) -> torch.Tensor:
    """Patch-embedding weight [out, in, kt, kh, kw] to ``cfg.in_dim`` input
    channels: zero-padded (a 48-channel Control checkpoint into the 4D
    config) or cut."""
    cin = w.shape[1]
    if cin < cfg.in_dim:
        pad = w.new_zeros((w.shape[0], cfg.in_dim - cin) + w.shape[2:])
        return torch.cat([w, pad], dim=1)
    return w[:, :cfg.in_dim].contiguous()


def convert_dit_state_dict(sd, cfg: DiTConfig, seed: int = 0,
                           dtype: torch.dtype = torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """A released-layout state dict -> the port's ``WanDiT`` state dict at
    ``cfg``, in ``dtype``: the required keys, the surgery and the fresh
    initialisation of absent 4D groups (see the module docstring). Keys
    the model does not hold are left out; ``load_wan_dit_strict`` names
    them."""
    req, _ = wan_dit_key_manifest(cfg)
    out = {k: sd[k].to(dtype) for k in req}
    out["patch_embedding.weight"] = _patch_embed_surgery(
        sd["patch_embedding.weight"].to(torch.float32), cfg).to(dtype)
    d = cfg.dim
    if cfg.motion_guidance:
        fd = cfg.motion_feature_dim
        for i in range(cfg.num_layers):
            for n in ("spatial_guidance_self", "spatial_guidance_ffn"):
                p = f"blocks.{i}.{n}"
                if p + ".spatial_guide.1.weight" in sd:
                    for k in (".spatial_guide.1.weight",
                              ".spatial_guide.1.bias", ".gate"):
                        out[p + k] = sd[p + k].to(dtype)
                else:
                    # the reference's fresh FiLM: an exact identity
                    out[p + ".spatial_guide.1.weight"] = torch.zeros(
                        2 * d, fd, dtype=dtype)
                    out[p + ".spatial_guide.1.bias"] = torch.zeros(
                        2 * d, dtype=dtype)
                    out[p + ".gate"] = torch.zeros(d, dtype=dtype)
    rs = np.random.RandomState(seed)

    def conv(name, present, *shape):
        w, b = ((sd[name + ".weight"], sd[name + ".bias"]) if present
                else _xavier_conv(rs, *shape))
        out[name + ".weight"], out[name + ".bias"] = w.to(dtype), b.to(dtype)

    if cfg.ref_conv:
        conv("ref_conv", "ref_conv.weight" in sd, cfg.patch_size[1],
             cfg.patch_size[2], cfg.ref_conv_dim, d)
    if cfg.motion_guidance:
        fd, present = cfg.motion_feature_dim, "feature_adapter.0.weight" in sd
        conv("feature_adapter.0", present, 3, 3, fd, fd)
        conv("feature_adapter.2", present, 3, 3, fd, fd)
    return out


def model_state_shapes(cfg: DiTConfig) -> Dict[str, Tuple[int, ...]]:
    """Every state-dict entry of ``WanDiT(cfg)`` and its shape, from a
    model built on the meta device (no memory, so the 14B checks in
    seconds)."""
    from ..models.wan_dit import WanDiT

    with torch.device("meta"):
        model = WanDiT(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def load_wan_dit_strict(sd, cfg: DiTConfig, seed: int = 0,
                        dtype: torch.dtype = torch.float32):
    """Convert and verify a released-layout state dict, failing loudly with
    the whole structured diff: (a) required keys the checkpoint lacks, (b)
    keys nothing consumes, (c) optional groups partly present, (d)
    converted entries whose shapes disagree with ``WanDiT(cfg)`` (built on
    the meta device, where the JAX loader uses ``jax.eval_shape``). Returns
    ``(state_dict, report)``; the patch-embedding surgery runs, it is not
    skipped."""
    keys = set(sd)
    omni = sorted(k for k in keys if k.startswith(OMNIMAE_PREFIX))
    keys -= set(omni)
    req, opt = wan_dit_key_manifest(cfg)
    errors = []
    missing = sorted(set(req) - keys)
    if missing:
        errors.append(f"checkpoint LACKS {len(missing)} required keys:\n  "
                      + "\n  ".join(missing))
    known = set(req)
    groups = {}
    for name, gkeys in opt.items():
        known |= set(gkeys)
        present = keys & set(gkeys)
        if not present:
            groups[name] = ("absent -> fresh-init with reference "
                            "strict=False semantics")
        elif len(present) == len(gkeys):
            groups[name] = "present"
        else:
            absent = sorted(set(gkeys) - present)
            errors.append(
                f"optional group '{name}' is PARTIALLY present "
                f"({len(present)}/{len(gkeys)}; drifted layout?) — "
                f"missing:\n  " + "\n  ".join(absent))
    unmapped = sorted(keys - known)
    if unmapped:
        errors.append(f"checkpoint has {len(unmapped)} keys the converter "
                      f"does NOT consume:\n  " + "\n  ".join(unmapped))
    if errors:
        raise ValueError(f"Wan DiT strict load failed ({len(errors)} "
                         f"problem group(s)):\n\n" + "\n\n".join(errors))

    converted = convert_dit_state_dict(sd, cfg, seed=seed, dtype=dtype)
    expect = model_state_shapes(cfg)
    for k, v in converted.items():
        if k not in expect:
            errors.append(f"converted key {k} has no counterpart in the "
                          f"model graph")
        elif tuple(v.shape) != expect[k]:
            errors.append(f"shape mismatch at {k}: checkpoint -> "
                          f"{tuple(v.shape)}, model expects {expect[k]}")
    for k in expect:
        if k not in converted:
            errors.append(f"model expects {k} but the conversion did not "
                          f"produce it")
    if errors:
        raise ValueError(f"Wan DiT strict load failed ({len(errors)} "
                         f"problem group(s)):\n\n" + "\n\n".join(errors))
    report = {"omnimae_embedded_keys": len(omni), "groups": groups,
              "ckpt_in_dim": int(sd["patch_embedding.weight"].shape[1]),
              "model_in_dim": cfg.in_dim}
    return converted, report


def read_state_dict(path: str, dtype=None) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors on the CPU: a directory of
    ``diffusion_pytorch_model*.safetensors`` shards (or, failing those,
    of ``*.safetensors``; read in parallel), a ``.safetensors`` file, or a
    torch file (weights only; a ``state_dict``, ``model`` or ``module``
    entry unwrapped). ``dtype`` casts the floating tensors as they are
    read."""
    def cast(t):
        return t.to(dtype, copy=True) if dtype is not None \
            and t.is_floating_point() else t

    def read(f):
        return {k: cast(v) for k, v in load_file(f).items()}

    if os.path.isdir(path):
        refuse_orbax(path)
        files = sorted(glob.glob(os.path.join(
            path, "diffusion_pytorch_model*.safetensors"))) or sorted(
            glob.glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"{path}: no .safetensors shards")
        sd = {}
        # shard reads are I/O-bound and the copies release the GIL
        with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
            for shard in ex.map(read, files):
                sd.update(shard)
        return sd
    if path.endswith(".safetensors"):
        return read(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict (got {type(sd)})")
    return {k: cast(v) for k, v in sd.items()}


def load_wan_dit(path: str, cfg: DiTConfig, prefer_ema: bool = False,
                 dtype: torch.dtype = torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """The port's ``WanDiT`` state dict at ``cfg``, in ``dtype``, from a
    released checkpoint (see ``read_state_dict``; converted by
    ``convert_dit_state_dict``) or from a checkpoint directory of the
    port's trainers (``train/checkpoint.py``: already the port's names;
    ``prefer_ema`` takes its EMA weights, falling back to the params when
    it holds none)."""
    if os.path.isdir(path) and glob.glob(os.path.join(path, "*",
                                                      "state.pt")):
        saved = CheckpointManager(path).restore()
        tree = saved["params"]
        if prefer_ema:
            if saved.get("ema") is not None:
                tree = saved["ema"]
            else:
                print(f"NOTE: no EMA tree in {path}; loading raw params")
        return {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in tree.items()}
    return convert_dit_state_dict(read_state_dict(path, dtype), cfg,
                                  dtype=dtype)
