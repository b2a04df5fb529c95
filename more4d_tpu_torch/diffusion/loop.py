"""The Wan pipelines' denoise loop and its TeaCache (PyTorch port of the
loops of ``more4d_tpu/pipelines/base.py`` and ``parallel/offload.py``).

One loop serves the resident DiT (``pipelines/base.py``, over
``WanDiT.backbone``) and the streamed one (``parallel/offload.py``, over
``StreamedDiT.backbone``); the block walk is all that differs. Each step is
one CFG-doubled DiT forward, the guidance combine and a sampler step; with
``cfg_skip_ratio`` the last steps run the cond half alone.

TeaCache: a calc step runs the walk and keeps ``tokens - tokens_in`` in the
model dtype; a replay step adds it to the embedded tokens and runs no
block. After cfg-skip the cond halves (the last B rows) carry on. With
``offload_residual`` the residual waits in pinned host memory between
steps. Two decision rules, each held to its JAX counterpart (they differ
when ``num_skip_start_steps`` is 0, and in float32 against float64): the
resident loop's ``TeaCacheState`` decides each step from the step's e0;
the streamed loop's ``ScheduleTeaCache`` decides the whole schedule before
the first step from ``time_embed_e0`` of every timestep.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

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
    # park the cached residual in pinned host memory between steps: frees
    # the [2B, L, D] buffer on the card for one host->card read a replay
    # step and one write a calc step; the same latents bit for bit
    offload_residual: bool = False


class _Residual:
    """What both TeaCache rules keep between steps: the last calc step's
    residual (on the card, or in host memory with ``offload``) and ``log``,
    one (rel, poly, calc) a step. A rule answers ``decide(e0)`` once a
    step, after ``begin`` before the first."""

    def __init__(self, offload: bool):
        self.offload = offload
        self.residual: Optional[torch.Tensor] = None
        self.log: List[Tuple[float, float, bool]] = []

    def begin(self, dit, timesteps) -> None:
        pass

    def cond_half(self, b: int) -> None:
        """Keep the cond halves (the last ``b`` rows) of a CFG-doubled
        batch, for the cond-only tail after cfg-skip."""
        if self.residual is not None:
            self.residual = self.residual[-b:]

    def store(self, residual: torch.Tensor) -> None:
        """Keep a calc step's residual: as it is, or copied into host memory
        (pinned when it comes from the card) with ``offload``."""
        if not self.offload:
            self.residual = residual
            return
        if self.residual is None or self.residual.shape != residual.shape:
            self.residual = torch.empty(
                residual.shape, dtype=residual.dtype,
                pin_memory=residual.device.type == "cuda")
        self.residual.copy_(residual, non_blocking=True)

    def cached(self, like: torch.Tensor) -> torch.Tensor:
        """The residual for a replay step, on ``like``'s device, in its
        dtype (zeros before any calc step)."""
        if self.residual is None:
            return torch.zeros_like(like)
        return self.residual.to(like.device, like.dtype, non_blocking=True)


class TeaCacheState(_Residual):
    """The resident loop's rule. ``decide`` is the JAX package's decision
    in float32: rel = mean|e0 - prev| / max(mean|prev|, 1e-8),
    accum += polyval(coefficients, rel) (Horner's rule), reset to 0 while
    fewer than ``num_skip_start_steps`` steps have run; the step computes
    while warming up or once accum >= rel_l1_thresh, and accum then
    resets."""

    def __init__(self, tc: TeaCacheConfig):
        super().__init__(tc.offload_residual)
        self.tc = tc
        self.prev_e0: Optional[torch.Tensor] = None
        self.accum = np.float32(0.0)
        self.steps_seen = 0

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

    def cond_half(self, b: int) -> None:
        super().cond_half(b)
        if self.prev_e0 is not None:
            self.prev_e0 = self.prev_e0[-b:]


class ScheduleTeaCache(_Residual):
    """The streamed loop's rule, as the JAX streamed loop decides it:
    rel = mean|e0 - prev| / max(mean|prev|, 1e-12) in numpy float32, the
    rescale polynomial (``np.polyval``) accumulated in float64; a step
    computes while fewer than ``num_skip_start_steps`` steps have run (or
    on the first), or once the accumulation reaches the threshold, which
    resets it. ``begin`` decides every step of the schedule."""

    def __init__(self, coefficients, rel_l1_thresh, num_skip_start_steps):
        super().__init__(offload=False)
        self.coefficients = list(coefficients)
        self.rel_l1_thresh = float(rel_l1_thresh)
        self.num_skip_start_steps = int(num_skip_start_steps)
        self.cnt = 0
        self.accum = 0.0
        self.prev_e0 = None
        self._plan = iter(())

    def should_calc(self, e0: np.ndarray) -> bool:
        e0 = np.asarray(e0, np.float32)
        rel = poly = 0.0
        if self.cnt < self.num_skip_start_steps or self.prev_e0 is None:
            calc = True
            self.accum = 0.0
        else:
            rel = float(np.abs(e0 - self.prev_e0).mean()
                        / max(np.abs(self.prev_e0).mean(), 1e-12))
            poly = float(np.polyval(self.coefficients, rel))
            self.accum += poly
            calc = self.accum >= self.rel_l1_thresh
            if calc:
                self.accum = 0.0
        self.prev_e0 = e0
        self.cnt += 1
        self.log.append((rel, poly, calc))
        return calc

    def begin(self, dit, timesteps) -> None:
        """Every step's decision from ``dit.time_embed_e0`` of the whole
        schedule (called on the instance, so an FSDP2-sharded DiT gathers
        its parameters; under a seq mesh seq rank 0's e0, so the ranks of
        a sequence decide alike); the first step always computes."""
        timesteps = np.asarray(timesteps, np.float32)
        _, e0s = dit.time_embed_e0(torch.from_numpy(timesteps))
        e0s = _seq_first(e0s.float()).cpu().numpy()
        calc = [self.should_calc(e0s[i:i + 1]) for i in range(len(e0s))]
        calc[0] = True
        self._plan = iter(calc)

    def decide(self, e0: torch.Tensor) -> bool:
        return next(self._plan)


def _seq_first(t: torch.Tensor) -> torch.Tensor:
    """``t`` as seq rank 0 computed it, under an installed seq mesh of
    size S > 1 (the ranks of one sequence must take one calc/replay
    decision a step: a rank that replayed while another computed would
    leave the other's all-to-alls unanswered); else ``t``."""
    from ..parallel.mesh import broadcast_from_first
    from ..parallel.ulysses import get_mesh, seq_parallel_size

    if seq_parallel_size() == 1:
        return t
    return broadcast_from_first([t], get_mesh().get_group("seq"))[0]


def dit_forward(dit, walk: Callable, rope_tables, x_in, t, ctx, y, clip, mpm,
                tc: Optional[_Residual]) -> torch.Tensor:
    """One step's DiT forward: ``dit.embed``, then the block walk ``walk``
    over its intermediates (a TeaCache replay step adds the cached residual
    instead), then ``dit.finalize``."""
    it = dit.embed(x_in, t, ctx, y=y, clip_fea=clip, mpm_features=mpm,
                   rope_tables=rope_tables)
    if tc is None or tc.decide(it.e0):
        tokens = walk(it)
        if tc is not None:
            tc.store(tokens - it.tokens)
    else:
        tokens = it.tokens + tc.cached(it.tokens)
    return dit.finalize(tokens, it)


def sampler_step(forward: Callable, scheduler, i, latents, sched_state, ctx,
                 y, clip, mpm, guidance, cfg_double, tc):
    """Sampler step ``i``: ``forward`` on the latents (doubled with
    ``cfg_double``, then the guidance combine), then ``scheduler.step``."""
    x_in = torch.cat([latents, latents]) if cfg_double else latents
    t = torch.full((x_in.shape[0],), float(scheduler.timesteps[i]),
                   dtype=torch.float32, device=latents.device)
    pred = forward(x_in, t, ctx, y, clip, mpm, tc)
    if cfg_double:
        uncond, cond = pred.chunk(2)
        pred = uncond + guidance * (cond - uncond)
    return scheduler.step(i, latents, pred.float(), sched_state)


@torch.no_grad()
def denoise(dit, step: Callable, scheduler, device, latents, prompt_embeds,
            neg_embeds=None, y=None, clip_fea=None, mpm_features=None,
            guidance_scale: float = 6.0, cfg_skip_ratio: float = 0.0,
            teacache: Optional[_Residual] = None):
    """The full loop on ``device``: ``step`` (``sampler_step`` bound to a
    ``dit_forward`` and ``scheduler``) once a sampler step. latents: [B,
    T', h, w, 16] initial noise; prompt/neg embeds: [B, L, text_dim]. CFG
    doubles the batch when ``guidance_scale`` > 1 and ``neg_embeds`` is
    given, but for the last ceil(n * ``cfg_skip_ratio``) steps.
    ``teacache``: a rule, or None to compute every step. Returns the final
    latents."""

    def put(a):
        return None if a is None else a.to(device)

    latents = latents.to(device, torch.float32)
    prompt_embeds, neg_embeds = put(prompt_embeds), put(neg_embeds)
    y, clip_fea, mpm_features = put(y), put(clip_fea), put(mpm_features)
    do_cfg = guidance_scale > 1.0 and neg_embeds is not None
    n = scheduler.num_steps
    n_cfg = n - int(math.ceil(n * cfg_skip_ratio)) if do_cfg else 0
    if teacache is not None:
        teacache.begin(dit, scheduler.timesteps)
    # the sampler's state, carried across the CFG-doubled steps and the
    # cond-only tail alike (TeaCache replays step it too)
    state = scheduler.init_state(latents.shape, device=device)
    if n_cfg > 0:
        def dup(a):
            return None if a is None else torch.cat([a, a])

        doubled = (torch.cat([neg_embeds, prompt_embeds]), dup(y),
                   dup(clip_fea), dup(mpm_features))
    for i in range(n):
        if teacache is not None and i == n_cfg > 0:
            teacache.cond_half(latents.shape[0])
        inputs = doubled if i < n_cfg else (prompt_embeds, y, clip_fea,
                                            mpm_features)
        latents, state = step(i, latents, state, *inputs, guidance_scale,
                              i < n_cfg, teacache)
    return latents
