"""Model/pipeline configuration dataclasses (PyTorch port).

A copy of ``more4d_tpu/config.py`` with torch dtypes: the JAX file imports
``jax.numpy`` for its dtypes, so it cannot be shared. Field names, defaults
and size presets are the JAX package's, so a config reads the same in both.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Wan DiT backbone configuration.

    ``motion_guidance=True`` selects the 4D-STraG variant (Motion Perception
    Module FiLM conditioning in every block); ``False`` is the plain
    Wan2.1-Fun 3D DiT used by 4D-ViSM.
    """

    model_type: str = "i2v"                     # 't2v' | 'i2v' — cross-attn variant
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 64                            # 16 noise + 48 cond latents
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    clip_dim: int = 1280                        # CLIP ViT-H token width
    clip_tokens: int = 257                      # i2v image-context tokens
    motion_guidance: bool = False               # 4D variant: OmniMAE FiLM guidance
    motion_feature_dim: int = 768               # OmniMAE ViT-B width
    use_cls_token: bool = False
    ref_conv: bool = False                      # prepend ref-image token frame
    ref_conv_dim: int = 16
    control_adapter: bool = False               # Plücker camera adapter
    control_adapter_dim: int = 24               # 6 rays x 4 folded frames
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # per-block rematerialisation when a gradient is taken: 'nothing' keeps
    # only each checkpointed block's input and recomputes the block in the
    # backward; remat_fraction checkpoints an evenly spaced fraction of the
    # blocks. The JAX package's other policies ('dots', 'flash*',
    # '*_offload') are not ported yet.
    remat: bool = False
    remat_policy: str = "nothing"
    remat_fraction: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def rope_dims(self) -> Tuple[int, int, int]:
        """Per-axis rotary sub-dimensions (t, h, w)."""
        d = self.head_dim
        return d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6)


# Reference model sizes (Wan2.1 family).
WAN_1_3B = dict(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30)
WAN_14B = dict(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40)


def dit_tiny(**kw) -> DiTConfig:
    """Small config for tests — same code path as the full models."""
    base = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, text_dim=32,
                clip_dim=32, motion_feature_dim=16, in_dim=64, out_dim=16,
                text_len=26, clip_tokens=9)
    base.update(kw)
    return DiTConfig(**base)


def dit_14b(motion_guidance: bool, **kw) -> DiTConfig:
    base = dict(WAN_14B)
    base.update(motion_guidance=motion_guidance)
    base.update(kw)
    return DiTConfig(**base)


def dit_1_3b(motion_guidance: bool = False, **kw) -> DiTConfig:
    base = dict(WAN_1_3B)
    base.update(motion_guidance=motion_guidance)
    base.update(kw)
    return DiTConfig(**base)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Wan 3D-causal video VAE (dim=96, z=16)."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    temporal_downsample: Tuple[bool, ...] = (False, True, True)
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    @property
    def temporal_ratio(self) -> int:
        return 2 ** sum(self.temporal_downsample)

    @property
    def spatial_ratio(self) -> int:
        return 2 ** (len(self.dim_mult) - 1)


def vae_tiny(**kw) -> VAEConfig:
    base = dict(dim=8, z_dim=4, dim_mult=(1, 2), num_res_blocks=1,
                temporal_downsample=(True,))
    base.update(kw)
    return VAEConfig(**base)


# Per-channel latent normalization of the released Wan2.1 VAE.
WAN_VAE_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
WAN_VAE_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5-xxl encoder (the text tower, ``models/t5.py``)."""

    vocab: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False
    dropout: float = 0.0
    text_len: int = 512
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def t5_tiny(**kw) -> T5Config:
    base = dict(vocab=128, dim=32, dim_attn=32, dim_ffn=64, num_heads=2,
                num_layers=2)
    base.update(kw)
    return T5Config(**base)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """open-clip ViT-H/14 vision tower (``models/clip.py``)."""

    image_size: int = 224
    patch_size: int = 14
    dim: int = 1280
    mlp_ratio: float = 4.0
    num_heads: int = 16
    num_layers: int = 32
    pool_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def clip_vision_tiny(**kw) -> CLIPVisionConfig:
    base = dict(image_size=28, patch_size=14, dim=32, num_heads=2,
                num_layers=2, pool_dim=16)
    base.update(kw)
    return CLIPVisionConfig(**base)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 5.0                          # training shift; inference uses 3.0


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_inference_steps: int = 50
    guidance_scale: float = 6.0
    shift: float = 3.0
    scheduler: str = "flow"                     # only 'flow' is ported so far
    scheduler_kwargs: Tuple[Tuple[str, Any], ...] = ()
    num_frames: int = 49
    height: int = 368
    width: int = 512
    # the JAX config's field; the pipelines take a TeaCacheConfig instead
    teacache_threshold: float = 0.0
    teacache_skip_start_steps: int = 5
    cfg_skip_ratio: float = 0.0
    riflex_k: Optional[int] = None
    # latent frames per streamed VAE encode/decode step; any value gives
    # the same numbers (1 is the reference's frame-at-a-time pattern)
    vae_latents_per_step: int = 1
