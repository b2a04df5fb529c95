"""The conditioning towers the 4D-STraG DiT reads (PyTorch port of
``more4d_tpu/infer/encoders.py``):

- text: a tokenizer and umT5-xxl -> context [B, text_len, 4096], the
  embeddings zeroed past each prompt's length;
- clip: CLIP ViT-H -> 257 penultimate visual tokens per image [B, 257,
  1280];
- mpm: OmniMAE ViT-B patch tokens [B, 196, 768] for the Motion Perception
  Module.

Each builder takes a checkpoint path, a state dict, or the tower itself,
plus ``weight_dtype`` (the dtype the weights are stored in; None keeps
them) and ``device``. A path or a state dict loads under the reference
checkpoints' names into the tower built on the meta device, each tensor
cast to ``weight_dtype`` and assigned (``load_state_dict(strict=True,
assign=True)``), so the host holds about the checkpoint's own size; keys
the tower does not hold (CLIP's last block, its text tower and head)
are named, not loaded. The text builder takes ``tokenize(prompts) ->
(ids, mask)``; ``build_tokenize`` makes one from a ``transformers``
tokenizer, as the JAX builder does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..config import CLIPVisionConfig, T5Config
from ..models.clip import ClipVisionTower, encode_image
from ..models.omnimae import (extract_mpm_features, infer_omnimae_variant,
                              omnimae_vit)
from ..models.t5 import WanT5Encoder
from ..nn.layers import from_state_dict

Tokenize = Callable[[List[str]], Tuple[object, object]]


@dataclasses.dataclass
class ConditioningEncoders:
    encode_text: Callable[[Sequence[str]], torch.Tensor]
    encode_clip: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    extract_mpm: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def _state_dict(src) -> Dict[str, torch.Tensor]:
    if isinstance(src, (str, os.PathLike)):
        src = torch.load(src, map_location="cpu", weights_only=True)
    return dict(src)


def _load(make, sd, prefix: str, what: str, weight_dtype):
    """``make()``'s module built on the meta device and given the keys of
    ``sd`` under ``prefix`` (dropped) that it holds, strictly, each cast to
    ``weight_dtype`` (None: float32, the towers' own) and assigned, so no
    float32 copy of the tower is made; the names of the other keys are
    printed."""
    with torch.device("meta"):
        own = set(make().state_dict())
    take = {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and k[len(prefix):] in own}
    left = sorted(set(sd) - {prefix + k for k in take})
    if left:
        print(f"{what}: {len(left)} checkpoint keys not used: "
              + ", ".join(left[:8]) + (" ..." if len(left) > 8 else ""))
    return from_state_dict(make, take, weight_dtype or torch.float32)


def _tower(src, make, prefix, what, weight_dtype, device):
    """The tower ``src`` names (a module, or a path or state dict loaded
    into ``make()``), in ``weight_dtype`` on ``device``, in eval mode."""
    if isinstance(src, nn.Module):
        module = src if weight_dtype is None else src.to(weight_dtype)
    else:
        module = _load(make, _state_dict(src), prefix, what, weight_dtype)
    return module.to(device).eval()


def build_tokenize(tokenizer_path: str, text_len: int = 512) -> Tokenize:
    """``tokenize(prompts) -> (ids, mask)`` from
    ``transformers.AutoTokenizer`` (imported here, when called), padded
    and cut to ``text_len`` with the special tokens, as the JAX text
    builder calls it."""
    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(tokenizer_path)

    def tokenize(prompts: List[str]):
        toks = tokenizer(list(prompts), padding="max_length",
                         truncation=True, max_length=text_len,
                         add_special_tokens=True, return_tensors="np")
        return toks["input_ids"], toks["attention_mask"]

    return tokenize


def build_text_encoder(t5, tokenize: Tokenize,
                       cfg: T5Config = T5Config(),
                       weight_dtype: Optional[torch.dtype] = None,
                       device="cuda"):
    """``tokenize`` + umT5 -> encode_text(prompts) -> [B, text_len, dim].
    The ids are cut or zero-padded to ``cfg.text_len`` (the JAX builder's
    ``padding="max_length", truncation=True``); the embeddings past each
    prompt's length are zeroed."""
    dev = resolve_device(device)
    model = _tower(t5, lambda: WanT5Encoder(cfg), "", "umT5", weight_dtype,
                   dev)
    n = model.cfg.text_len

    def fit(a, dtype):
        a = torch.as_tensor(a, device=dev).to(dtype)[:, :n]
        return torch.nn.functional.pad(a, (0, n - a.shape[1]))

    @torch.no_grad()
    def encode_text(prompts: Sequence[str]) -> torch.Tensor:
        ids, mask = tokenize(list(prompts))
        ids, mask = fit(ids, torch.long), fit(mask, torch.float32)
        return model(ids, mask) * mask[..., None]

    return encode_text


def build_clip_encoder(clip, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                       weight_dtype: Optional[torch.dtype] = None,
                       device="cuda"):
    """CLIP's vision tower -> encode_clip(images in [-1, 1]) -> [B, 257,
    1280]. From a checkpoint, the ``visual.`` keys of blocks 0-30 and the
    embeddings load; the rest are named."""
    dev = resolve_device(device)
    tower = _tower(clip, lambda: ClipVisionTower(cfg), "visual.", "CLIP",
                   weight_dtype, dev)

    @torch.no_grad()
    def encode_clip(images: torch.Tensor) -> torch.Tensor:
        return encode_image(tower, images.to(dev))

    return encode_clip


def load_mpm_trunk(omnimae, weight_dtype: Optional[torch.dtype] = None,
                   device="cuda") -> nn.Module:
    """OmniMAE's trunk (a module, or a checkpoint path or state dict) in
    ``weight_dtype`` on ``device``. From a checkpoint, the B/L/H variant
    comes from its shapes; a 4D-STraG checkpoint's embedded trunk
    (``omnimae_extractor.``) and a ``trunk.`` prefix are read as the
    trunk, and the patch conv is taken as ``patch_embed.proj.1.*`` or
    ``patch_embed.proj.*``, as the JAX converter takes it."""
    dev = resolve_device(device)
    if isinstance(omnimae, nn.Module):
        return _tower(omnimae, None, "", "OmniMAE", weight_dtype, dev)
    sd = _state_dict(omnimae)
    for prefix in ("omnimae_extractor.", "trunk."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items()
                  if k.startswith(prefix)}
    if "patch_embed.proj.1.weight" not in sd:
        sd = {(k.replace("patch_embed.proj.", "patch_embed.proj.1.", 1)
               if k in ("patch_embed.proj.weight", "patch_embed.proj.bias")
               else k): v for k, v in sd.items()}
    variant = infer_omnimae_variant(sd)
    return _tower(sd, lambda: omnimae_vit(variant), "", "OmniMAE",
                  weight_dtype, dev)


def build_mpm_extractor(omnimae, weight_dtype: Optional[torch.dtype] = None,
                        device="cuda"):
    """OmniMAE's trunk (``load_mpm_trunk``) -> extract_mpm(images01) ->
    [B, N, D] patch tokens."""
    model = load_mpm_trunk(omnimae, weight_dtype, device)
    dev = resolve_device(device)

    @torch.no_grad()
    def extract_mpm(images01: torch.Tensor) -> torch.Tensor:
        return extract_mpm_features(model, images01.to(dev))[0]

    return extract_mpm


def build_encoders(t5=None, tokenize: Optional[Tokenize] = None, clip=None,
                   omnimae=None, text_dim: int = 4096, text_len: int = 512,
                   allow_dummy_text: bool = False,
                   weight_dtype: Optional[torch.dtype] = None,
                   device="cuda") -> ConditioningEncoders:
    """The bundle; a missing CLIP or OmniMAE tower gives None. A missing
    umT5 is an error unless ``allow_dummy_text``, when the text context is
    zeros (the unconditional context for every prompt)."""
    dev = resolve_device(device)
    if t5 is not None:
        if tokenize is None:
            raise ValueError("build_encoders: umT5 needs a tokenize callable")
        encode_text = build_text_encoder(t5, tokenize, T5Config(
            text_len=text_len), weight_dtype, dev)
    else:
        if not allow_dummy_text:
            raise ValueError(
                "no umT5 given: text conditioning would be all zeros. Pass "
                "t5, or allow_dummy_text=True to opt in explicitly (tests "
                "and smoke runs only).")
        print("WARNING: no umT5; text conditioning will be zeros")

        def encode_text(prompts):
            return torch.zeros((len(prompts), text_len, text_dim),
                               device=dev)

    return ConditioningEncoders(
        encode_text=encode_text,
        encode_clip=(None if clip is None else
                     build_clip_encoder(clip, weight_dtype=weight_dtype,
                                        device=dev)),
        extract_mpm=(None if omnimae is None else
                     build_mpm_extractor(omnimae, weight_dtype, dev)))
