"""Shared denoise-loop machinery for the Wan pipelines (PyTorch port of
``more4d_tpu/pipelines/base.py``).

Each step is one CFG-doubled DiT forward (uncond and cond halves in one
batch) followed by the guidance combine and a sampler step; with
``cfg_skip_ratio`` the last steps run the cond half alone. The loop is a
plain Python loop.

TeaCache: each step's decision is made on the host from the modulated
timestep embedding e0 (its relative L1 distance from the previous step's,
through the backbone's rescale polynomial, accumulated). A calc step runs
the block stack and keeps ``tokens - tokens_in`` in the model dtype; a
replay step adds that residual to the embedded tokens and runs no block,
so it launches no attention kernel. Across the cfg-skip transition the
state continues from the cond halves, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import PipelineConfig
from ..diffusion import get_scheduler
from ..models.vae_streaming import decode_streamed, encode_streamed
from ..models.wan_dit import WanDiT
from ..models.wan_vae import WanVAE
from ..nn.rope import RopeTables

# TeaCache rescale polynomials per backbone (highest power first)
TEACACHE_COEFFICIENTS = {
    "wan2.1-fun-1.3b": [-5.21862437e+04, 9.23041404e+03, -5.28275948e+02,
                        1.36987616e+01, -4.99875664e-02],
    "wan2.1-t2v-14b": [-3.03318725e+05, 4.90537029e+04, -2.65530556e+03,
                       5.87365115e+01, -3.15583525e-01],
    "wan2.1-fun-14b": [8.10705460e+03, 2.13393892e+03, -3.72934672e+02,
                       1.66203073e+01, -4.17769401e-02],
}


@dataclasses.dataclass(frozen=True)
class TeaCacheConfig:
    coefficients: Tuple[float, ...]
    rel_l1_thresh: float = 0.1
    num_skip_start_steps: int = 5
    # the JAX package's residual parked in pinned host memory; not ported
    offload_residual: bool = False


class TeaCacheState:
    """One denoise loop's TeaCache state. ``decide`` is the JAX package's
    decision in float32: rel = mean|e0 - prev| / max(mean|prev|, 1e-8),
    accum += polyval(coefficients, rel) (Horner's rule), reset to 0 while
    fewer than ``num_skip_start_steps`` steps have run; the step computes
    while warming up or once accum >= rel_l1_thresh, and accum then
    resets. ``log`` keeps one (rel, poly, calc) per step."""

    def __init__(self, tc: TeaCacheConfig):
        self.tc = tc
        self.prev_e0: Optional[torch.Tensor] = None
        self.accum = np.float32(0.0)
        self.residual: Optional[torch.Tensor] = None
        self.steps_seen = 0
        self.log: List[Tuple[float, float, bool]] = []

    def decide(self, e0: torch.Tensor) -> bool:
        e0 = e0.float()
        prev = torch.zeros_like(e0) if self.prev_e0 is None else self.prev_e0
        rel = ((e0 - prev).abs().mean()
               / prev.abs().mean().clamp_min(1e-8)).item()
        poly = np.float32(0.0)
        with np.errstate(over="ignore", invalid="ignore"):
            for c in self.tc.coefficients:
                poly = poly * np.float32(rel) + np.float32(c)
            warm = self.steps_seen < self.tc.num_skip_start_steps
            accum = np.float32(0.0) if warm else self.accum + poly
        calc = bool(warm or accum >= np.float32(self.tc.rel_l1_thresh))
        self.accum = np.float32(0.0) if calc else accum
        self.prev_e0 = e0
        self.steps_seen += 1
        self.log.append((rel, float(poly), calc))
        return calc

    def cond_half(self, b: int) -> "TeaCacheState":
        """The state of the cond halves (the last ``b`` rows) of a
        CFG-doubled batch, for the cond-only phase after cfg-skip."""
        half = TeaCacheState(self.tc)
        half.accum, half.steps_seen, half.log = (self.accum, self.steps_seen,
                                                 self.log)
        if self.prev_e0 is not None:
            half.prev_e0 = self.prev_e0[-b:]
        if self.residual is not None:
            half.residual = self.residual[-b:]
        return half


class BasePipeline:
    """Holds the DiT and the VAE (moved to ``device``) and runs the loop.
    ``device`` defaults to the card and raises if there is none.
    ``teacache``: a TeaCacheConfig, or None to compute every step."""

    def __init__(self, dit: WanDiT, vae: WanVAE,
                 config: PipelineConfig = PipelineConfig(), device="cuda",
                 teacache: Optional[TeaCacheConfig] = None):
        if teacache is not None and teacache.offload_residual:
            raise NotImplementedError(
                "TeaCache residual offload is not ported (ROADMAP Queue 1, "
                "memory modes)")
        self.device = resolve_device(device)
        self.teacache = teacache
        # the last denoise loop's TeaCache state (its log holds the
        # calc/replay sequence), None without TeaCache
        self.teacache_state: Optional[TeaCacheState] = None
        self.dit = dit.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.config = config
        self.scheduler = get_scheduler(config.scheduler,
                                       config.num_inference_steps,
                                       config.shift,
                                       **dict(config.scheduler_kwargs))
        riflex = {}
        if config.riflex_k:
            lt = (config.num_frames - 1) // 4 + 1
            riflex = dict(riflex_k=config.riflex_k, riflex_l_test=lt)
        self.rope_tables = RopeTables.create(dit.cfg.head_dim, **riflex)

    # ---------------- VAE helpers ---------------- #

    @torch.no_grad()
    def encode_video(self, video, static_hint: bool = False):
        """video [B,T,H,W,3] in [-1,1] -> deterministic (mode) latents,
        streamed in input-frame chunks [1, 4, 4, ...]."""
        mu, _ = encode_streamed(
            self.vae, video.to(self.device), static_hint=static_hint,
            latents_per_step=self.config.vae_latents_per_step)
        return mu.float()

    @torch.no_grad()
    def decode_latents(self, latents, normalize_output: bool = True):
        """Latents -> frames, streamed one latent frame at a time. True
        maps to [0, 1]; False returns the raw [-1, 1] decode used for
        trajectory tensors."""
        frames = decode_streamed(
            self.vae, latents.to(self.device),
            latents_per_step=self.config.vae_latents_per_step).float()
        if normalize_output:
            frames = (frames / 2 + 0.5).clamp(0.0, 1.0)
        return frames

    def prepare_latents(self, generator: torch.Generator, batch: int,
                        num_frames=None, height=None, width=None):
        """Initial noise [B, T', h, w, z] drawn from ``generator`` on the
        generator's device."""
        cfgp = self.config
        num_frames = num_frames or cfgp.num_frames
        height = height or cfgp.height
        width = width or cfgp.width
        vcfg = self.vae.cfg
        shape = (batch, (num_frames - 1) // vcfg.temporal_ratio + 1,
                 height // vcfg.spatial_ratio, width // vcfg.spatial_ratio,
                 vcfg.z_dim)
        return torch.randn(shape, generator=generator,
                           device=generator.device,
                           dtype=torch.float32).to(self.device)

    # ---------------- denoise loop ---------------- #

    def _forward(self, x_in, t, ctx, y, clip, mpm,
                 tc: Optional[TeaCacheState]):
        dit = self.dit
        it = dit.embed(x_in, t, ctx, y=y, clip_fea=clip, mpm_features=mpm,
                       rope_tables=self.rope_tables)
        if tc is None:
            tokens = dit.backbone(it)
        elif tc.decide(it.e0):
            tokens = dit.backbone(it)
            tc.residual = tokens - it.tokens
        else:
            residual = (torch.zeros_like(it.tokens) if tc.residual is None
                        else tc.residual)
            tokens = it.tokens + residual.to(it.tokens.dtype)
        return dit.finalize(tokens, it)

    def _step(self, i, latents, sched_state, ctx, y, clip, mpm, guidance,
              cfg_double, tc):
        x_in = torch.cat([latents, latents]) if cfg_double else latents
        t = torch.full((x_in.shape[0],), float(self.scheduler.timesteps[i]),
                       dtype=torch.float32, device=self.device)
        pred = self._forward(x_in, t, ctx, y, clip, mpm, tc)
        if cfg_double:
            uncond, cond = pred.chunk(2)
            pred = uncond + guidance * (cond - uncond)
        return self.scheduler.step(i, latents, pred.float(), sched_state)

    @torch.no_grad()
    def denoise(self, latents, prompt_embeds, neg_embeds=None, y=None,
                clip_fea=None, mpm_features=None, guidance_scale=None):
        """Full denoise loop. latents: [B, T', h, w, 16] initial noise;
        prompt/neg embeds: [B, L, text_dim]. Returns final latents."""
        cfgp = self.config
        if guidance_scale is None:
            guidance_scale = cfgp.guidance_scale
        dev = self.device

        def put(a):
            return None if a is None else a.to(dev)

        latents = latents.to(dev, torch.float32)
        prompt_embeds, neg_embeds = put(prompt_embeds), put(neg_embeds)
        y, clip_fea, mpm_features = put(y), put(clip_fea), put(mpm_features)
        do_cfg = guidance_scale > 1.0 and neg_embeds is not None
        n = self.scheduler.num_steps
        n_skip = int(math.ceil(n * cfgp.cfg_skip_ratio)) if do_cfg else 0
        n_cfg = (n - n_skip) if do_cfg else 0

        tc = None if self.teacache is None else TeaCacheState(self.teacache)
        self.teacache_state = tc
        # the sampler's state, carried across the CFG-doubled steps and the
        # cond-only tail alike (TeaCache replays step it too)
        state = self.scheduler.init_state(latents.shape, device=dev)
        if n_cfg > 0:
            def dup(a):
                return None if a is None else torch.cat([a, a])

            ctx2 = torch.cat([neg_embeds, prompt_embeds])
            y2, clip2, mpm2 = dup(y), dup(clip_fea), dup(mpm_features)
            for i in range(n_cfg):
                latents, state = self._step(i, latents, state, ctx2, y2,
                                            clip2, mpm2, guidance_scale, True,
                                            tc)
            if tc is not None and n_cfg < n:
                tc = self.teacache_state = tc.cond_half(latents.shape[0])
        for i in range(n_cfg, n):
            latents, state = self._step(i, latents, state, prompt_embeds, y,
                                        clip_fea, mpm_features,
                                        guidance_scale, False, tc)
        return latents
