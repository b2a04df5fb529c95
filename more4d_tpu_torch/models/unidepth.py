"""UniDepth-V2 monocular metric depth (PyTorch port of
``more4d_tpu/models/unidepth.py``), the stage-1 depth lift.

A DINOv2 ViT-L/14 encoder (``pixel_encoder``) feeds a decoder with (1) a
camera head: four learned camera tokens cross-attend to the adapted image
features and give pinhole intrinsics; (2) a depth head self-prompted with a
spherical-harmonics embedding of the back-projected unit rays, four
attention blocks, two transposed-conv upsamplings and a 3x3 conv to
log-depth at four times the patch grid.

Layer norms are eps 1e-6, as flax's default. Parameter names are the
documented correspondence the JAX converter reads (``pixel_encoder.`` plus
the dinov2 names; ``input_adapters.N``, ``camera_head.*``,
``depth_head.*`` as ``unidepth_decoder_key_manifest`` lists them), and
``up1``/``up2`` hold torch's ConvTranspose2d weights, which the JAX
converter flips into flax's kernels.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..nn.layers import (Conv2d, ConvTranspose2d, LayerNormF32, Linear,
                         dense_attention, lecun_init_, materialize)
from ..nn.resize import resize
from .dinov2 import DinoV2ViT, official_names
from .omnimae import imagenet_normalize


def spherical_harmonics(dirs: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """Real SH basis up to ``degree`` (inclusive) of unit directions
    [..., 3] -> [..., (degree+1)^2]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        comps += [-0.4886025119029199 * y,
                  0.4886025119029199 * z,
                  -0.4886025119029199 * x]
    if degree >= 2:
        comps += [1.0925484305920792 * x * y,
                  -1.0925484305920792 * y * z,
                  0.31539156525252005 * (3 * z * z - 1.0),
                  -1.0925484305920792 * x * z,
                  0.5462742152960396 * (x * x - y * y)]
    if degree >= 3:
        comps += [-0.5900435899266435 * y * (3 * x * x - y * y),
                  2.890611442640554 * x * y * z,
                  -0.4570457994644658 * y * (5 * z * z - 1.0),
                  0.3731763325901154 * z * (5 * z * z - 3.0),
                  -0.4570457994644658 * x * (5 * z * z - 1.0),
                  1.445305721320277 * z * (x * x - y * y),
                  -0.5900435899266435 * x * (x * x - 3 * y * y)]
    return torch.stack(comps, dim=-1)


class CrossBlock(nn.Module):
    """Pre-norm cross attention (separate norms for the queries and the
    context) and an exact-GELU MLP."""

    def __init__(self, dim: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNormF32(dim, cast_back=True)
        self.norm_ctx = LayerNormF32(dim, cast_back=True)
        for name in ("q", "k", "v", "proj"):
            setattr(self, name, Linear(dim, dim, dtype))
        self.norm2 = LayerNormF32(dim, cast_back=True)
        self.fc1 = Linear(dim, 4 * dim, dtype)
        self.fc2 = Linear(4 * dim, dim, dtype)

    def forward(self, x, ctx):
        b, l, c = x.shape
        n, d = self.num_heads, c // self.num_heads
        h, hc = self.norm1(x), self.norm_ctx(ctx)
        o = dense_attention(self.q(h).reshape(b, l, n, d),
                            self.k(hc).reshape(b, -1, n, d),
                            self.v(hc).reshape(b, -1, n, d), d ** -0.5)
        x = x + self.proj(o.reshape(b, l, c))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class CameraHead(nn.Module):
    """Pinhole intrinsics K [B, 3, 3] (in pixels of the input) from four
    learned camera tokens cross-attending to the image features."""

    def __init__(self, dim: int, num_blocks: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.camera_tokens = nn.Parameter(torch.zeros(1, 4, dim))
        self.blocks = nn.ModuleList(CrossBlock(dim, dtype=dtype)
                                    for _ in range(num_blocks))
        self.norm = LayerNormF32(dim, cast_back=True)
        self.proj = Linear(dim, 1, dtype)

    def forward(self, feats, height: int, width: int):
        b = feats.shape[0]
        x = self.camera_tokens.expand(b, -1, -1).to(feats.dtype)
        for blk in self.blocks:
            x = blk(x, feats)
        raw = self.proj(self.norm(x))[..., 0]                   # [B, 4]
        # fx, fy by a softplus around a ~0.7 W prior; cx, cy by a sigmoid
        fx = F.softplus(raw[:, 0] + 1.0) * 0.5 * width
        fy = F.softplus(raw[:, 1] + 1.0) * 0.5 * width
        cx = torch.sigmoid(raw[:, 2]) * width
        cy = torch.sigmoid(raw[:, 3]) * height
        zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, zeros, cx], -1),
                            torch.stack([zeros, fy, cy], -1),
                            torch.stack([zeros, zeros, ones], -1)], dim=1)


def rays_from_intrinsics(k_mat: torch.Tensor, gh: int, gw: int,
                         height: int, width: int) -> torch.Tensor:
    """Unit back-projected rays at the patch centres [B, gh*gw, 3]."""
    dev = k_mat.device
    ys = (torch.arange(gh, device=dev) + 0.5) * (height / gh)
    xs = (torch.arange(gw, device=dev) + 0.5) * (width / gw)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")     # [gh, gw]
    fx, fy = k_mat[:, 0, 0, None, None], k_mat[:, 1, 1, None, None]
    cx, cy = k_mat[:, 0, 2, None, None], k_mat[:, 1, 2, None, None]
    x = (grid_x[None] - cx) / fx
    y = (grid_y[None] - cy) / fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d.reshape(k_mat.shape[0], gh * gw, 3)


class DepthHead(nn.Module):
    """Camera-prompted depth decoder: feature tokens plus the SH ray
    embedding -> attention blocks -> two 2x transposed-conv upsamplings ->
    log-depth [B, 4 gh, 4 gw]."""

    def __init__(self, dim: int, num_blocks: int = 4, num_heads: int = 8,
                 sh_degree: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.sh_degree = dim, sh_degree
        self.ray_proj = Linear((sh_degree + 1) ** 2, dim, dtype)
        self.blocks = nn.ModuleList(CrossBlock(dim, num_heads, dtype)
                                    for _ in range(num_blocks))
        self.norm = LayerNormF32(dim, cast_back=True)
        self.up1 = ConvTranspose2d(dim, dim // 2, 2, stride=2, dtype=dtype)
        self.up2 = ConvTranspose2d(dim // 2, dim // 4, 2, stride=2,
                                   dtype=dtype)
        self.out = Conv2d(dim // 4, 1, 3, padding=1, dtype=dtype)

    def forward(self, feats, rays, grid: Tuple[int, int]):
        gh, gw = grid
        sh = spherical_harmonics(rays, self.sh_degree)
        x = feats + self.ray_proj(sh.to(feats.dtype))
        for blk in self.blocks:
            x = blk(x, x)
        h = self.norm(x).reshape(x.shape[0], gh, gw, self.dim)
        h = F.gelu(self.up1(h.permute(0, 3, 1, 2)))
        h = F.gelu(self.up2(h))
        return self.out(h)[:, 0]


class UniDepthV2(nn.Module):
    """image -> (depth, intrinsics)."""

    def __init__(self, backbone_dim: int = 1024, backbone_depth: int = 24,
                 backbone_heads: int = 16, hidden_dim: int = 512,
                 layer_ids: Sequence[int] = (5, 11, 17, 23),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_ids = tuple(layer_ids)
        self.pixel_encoder = DinoV2ViT(backbone_dim, backbone_depth,
                                       backbone_heads, dtype=dtype)
        self.input_adapters = nn.ModuleList(
            Linear(backbone_dim, hidden_dim, dtype) for _ in self.layer_ids)
        self.camera_head = CameraHead(hidden_dim, dtype=dtype)
        self.depth_head = DepthHead(hidden_dim, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "UniDepthV2":
        """The backbone's ``init_weights``; the decoder flax's defaults
        (``lecun_init_``) with camera tokens N(0, 0.02)."""
        for name, m in self.named_children():
            if name == "pixel_encoder":
                m.init_weights(generator)
            else:
                lecun_init_(m, generator)
        self.camera_head.camera_tokens.normal_(0.0, 0.02, generator=generator)
        return self

    def decode(self, levels, height: int, width: int,
               grid: Tuple[int, int]):
        """Per-level (patch tokens, cls) lists -> (depth, K)."""
        feats = 0.0
        for adapter, (tokens, _cls) in zip(self.input_adapters, levels):
            feats = feats + adapter(tokens)
        k_mat = self.camera_head(feats, height, width)
        rays = rays_from_intrinsics(k_mat, grid[0], grid[1], height, width)
        return torch.exp(self.depth_head(feats, rays, grid)), k_mat

    def forward(self, x):
        """x [B, H, W, 3] ImageNet-normalised, H and W multiples of 14 ->
        (depth [B, H/14*4, W/14*4], K [B, 3, 3])."""
        _, height, width, _ = x.shape
        levels, grid = self.pixel_encoder.get_intermediate_layers(
            x, self.layer_ids)
        return self.decode(levels, height, width, grid)


def preprocess(image01: torch.Tensor, pixel_budget: int = 518 * 518,
               multiple: int = 14):
    """[H, W, 3] in [0, 1] -> ([1, nh, nw, 3] ImageNet-normalised, (H, W)):
    a bilinear resize to about ``pixel_budget`` pixels at the same aspect,
    both sides multiples of 14 (368x512 -> 434x616)."""
    h, w = image01.shape[:2]
    scale = math.sqrt(pixel_budget / (h * w))
    nh = max(multiple, int(round(h * scale / multiple)) * multiple)
    nw = max(multiple, int(round(w * scale / multiple)) * multiple)
    x = resize(image01.float(), (nh, nw, 3))
    return imagenet_normalize(x)[None], (h, w)


def unidepth_decoder_key_manifest(num_adapters: int = 4,
                                  camera_blocks: int = 2,
                                  depth_blocks: int = 4) -> List[str]:
    """The exact decoder key names a UniDepth-V2 checkpoint holds (the
    JAX package's ``unidepth_decoder_key_manifest``, in its order)."""
    keys = []
    for i in range(num_adapters):
        keys += [f"input_adapters.{i}.weight", f"input_adapters.{i}.bias"]

    def block(p):
        out = []
        for n in ("norm1", "norm_ctx", "norm2"):
            out += [f"{p}.{n}.weight", f"{p}.{n}.bias"]
        for m in ("q", "k", "v", "proj", "fc1", "fc2"):
            out += [f"{p}.{m}.weight", f"{p}.{m}.bias"]
        return out

    keys.append("camera_head.camera_tokens")
    for i in range(camera_blocks):
        keys += block(f"camera_head.blocks.{i}")
    keys += ["camera_head.norm.weight", "camera_head.norm.bias",
             "camera_head.proj.weight", "camera_head.proj.bias",
             "depth_head.ray_proj.weight", "depth_head.ray_proj.bias"]
    for i in range(depth_blocks):
        keys += block(f"depth_head.blocks.{i}")
    keys += ["depth_head.norm.weight", "depth_head.norm.bias",
             "depth_head.up1.weight", "depth_head.up1.bias",
             "depth_head.up2.weight", "depth_head.up2.bias",
             "depth_head.out.weight", "depth_head.out.bias"]
    return keys


# released DINOv2 checkpoints carry the masked-image-modelling token, which
# inference never reads
IGNORABLE_BACKBONE_KEYS = frozenset({"mask_token", "embeddings.mask_token"})


def load_unidepth_strict(sd: Dict[str, torch.Tensor], model: UniDepthV2
                         ) -> Dict[str, object]:
    """Load a UniDepth-V2 checkpoint into ``model`` in place, failing
    loudly with the whole structured diff (the JAX package's
    ``load_unidepth_strict``): decoder keys the checkpoint lacks or that
    nothing reads, backbone keys nothing reads, and shapes that disagree
    with the model. A ``pixel_decoder.`` prefix on the decoder keys is
    dropped; the backbone may use the official DINOv2 names or the
    ``transformers`` ``Dinov2Model`` names (``dinov2.official_names``);
    ``mask_token`` is ignored.

    As the JAX provider's converter does, a checkpoint with no decoder key
    at all (encoder-only) keeps the model's heads as they are, and one
    with no ``pixel_encoder.`` key keeps its backbone. (The JAX strict
    loader refuses an encoder-only checkpoint; the port's provider loads
    through this function and takes what the JAX provider takes.) Returns
    a report: {'backbone': 'loaded'|'kept', 'decoder': 'loaded'|'kept',
    'ignored': [...]}."""
    sd = {(k[len("pixel_decoder."):] if k.startswith("pixel_decoder.")
           else k): v for k, v in sd.items()}
    enc = {k[len("pixel_encoder."):]: v for k, v in sd.items()
           if k.startswith("pixel_encoder.")}
    dec = {k: v for k, v in sd.items() if not k.startswith("pixel_encoder.")}
    errors, take = [], {}
    manifest = unidepth_decoder_key_manifest(
        len(model.input_adapters), len(model.camera_head.blocks),
        len(model.depth_head.blocks))
    if dec:
        missing = [k for k in manifest if k not in dec]
        unmapped = sorted(set(dec) - set(manifest))
        if missing:
            errors.append(f"checkpoint LACKS {len(missing)} expected decoder "
                          f"keys:\n  " + "\n  ".join(missing))
        if unmapped:
            errors.append(f"checkpoint has {len(unmapped)} keys the loader "
                          f"does NOT consume:\n  " + "\n  ".join(unmapped))
        take.update({k: v for k, v in dec.items() if k in manifest})
    ignored = sorted(set(enc) & IGNORABLE_BACKBONE_KEYS)
    if enc:
        official, consumed = official_names(enc,
                                            len(model.pixel_encoder.blocks))
        want = set(model.pixel_encoder.state_dict())
        missing = sorted(want - set(official))
        leftover = sorted(set(enc) - consumed - IGNORABLE_BACKBONE_KEYS)
        if missing:
            errors.append(f"backbone checkpoint LACKS {len(missing)} "
                          f"pixel_encoder keys (official names):\n  "
                          + "\n  ".join(missing))
        if leftover:
            errors.append(f"backbone checkpoint has {len(leftover)} "
                          f"pixel_encoder keys the loader does NOT "
                          f"consume:\n  " + "\n  ".join(leftover))
        take.update({"pixel_encoder." + k: v for k, v in official.items()
                     if k in want})
    own = model.state_dict()
    for k, v in take.items():
        if tuple(v.shape) != tuple(own[k].shape):
            errors.append(f"shape mismatch at {k}: checkpoint -> "
                          f"{tuple(v.shape)}, model expects "
                          f"{tuple(own[k].shape)}")
    if errors:
        raise ValueError("UniDepth strict load failed "
                         f"({len(errors)} problem group(s)):\n\n"
                         + "\n\n".join(errors))
    with torch.no_grad():
        for k, v in take.items():
            own[k].copy_(v)
    return {"backbone": "loaded" if enc else "kept",
            "decoder": "loaded" if dec else "kept", "ignored": ignored}


class UniDepthProvider:
    """A depth provider (``models.depth``) backed by the port's UniDepthV2:
    image01 [H, W, 3] in [0, 1] (array or tensor) -> depth [H, W] float32
    on ``device``. ``model`` is the graph (the ViT-L/14 default when None,
    its weights drawn from ``seed``); a checkpoint ``ckpt`` (a state dict,
    or one under ``state_dict``) loads into it through
    ``load_unidepth_strict``, else the weights are kept as given."""

    def __init__(self, model: Optional[UniDepthV2] = None,
                 pixel_budget: int = 518 * 518, seed: int = 0,
                 ckpt: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        if model is None:
            gen = torch.Generator(self.device).manual_seed(seed)
            model = materialize(UniDepthV2, self.device, torch.float32, gen)
        if ckpt is not None:
            sd = torch.load(ckpt, map_location="cpu", weights_only=True)
            self.load_report = load_unidepth_strict(sd.get("state_dict", sd),
                                                    model)
        self.model = model.to(self.device).eval()
        self.pixel_budget = pixel_budget

    @torch.no_grad()
    def __call__(self, image01) -> torch.Tensor:
        image01 = torch.as_tensor(image01, dtype=torch.float32,
                                  device=self.device)
        x, (h, w) = preprocess(image01, self.pixel_budget)
        depth, _k = self.model(x)
        return resize(depth[0].float(), (h, w))
