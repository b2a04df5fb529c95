"""Wan2.1-Fun DiT backbone (3D) and 4D-STraG variant for inference —
PyTorch port of ``more4d_tpu/models/wan_dit.py``.

- 3-axis RoPE over the (t, h, w) latent grid, with RIFLEx;
- adaLN with a per-block learned 6-way modulation table and a 2-way table
  in the output head;
- i2v cross attention: the CLIP image tokens prepended to the text context
  are split off at ``clip_tokens`` and go through their own k/v;
- Motion Perception Module (4D variant): OmniMAE first-frame patch
  features, adapted by a small conv stack, resized onto the latent grid and
  injected into every block through zero-initialised FiLM;
- optional ref_conv (reference-image token frame) and control adapter.

Public tensors keep the JAX layout: video latents [B, T, H, W, C], tokens
[B, L, D]. The block stack is an ``nn.ModuleList`` walked by a Python loop
(the JAX package scans stacked parameters). Module and parameter names are
the reference torch checkpoint's (``wan_dit_key_manifest`` in the JAX
package's ``convert/dit_torch.py``), so a released state dict loads as is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import DiTConfig
from ..kernels.rownorm import modulate
from ..nn.attention import attention
from ..nn.layers import (Conv2d, Conv3d, LayerNormAffine, LayerNormF32,
                         Linear, RMSNorm, compute_param, layer_norm,
                         sinusoidal_embedding)
from ..nn.remat import Remat, checkpoint_name, saved_names
from ..nn.resize import resize
from ..nn.rope import RopeTables, apply_rope, rope_angles_3d
from ..utils.profiling import spanned


def zero_mpm_fallback(cfg: DiTConfig, tokens, mpm, mask):
    """Zero MPM features + mask for a 4D (motion_guidance) model running
    without motion conditioning."""
    if mpm is None and cfg.motion_guidance:
        mpm = torch.zeros(tokens.shape[:2] + (cfg.motion_feature_dim,),
                          dtype=cfg.dtype, device=tokens.device)
        mask = torch.zeros((tokens.shape[1], 1), dtype=torch.float32,
                           device=tokens.device)
    return mpm, mask


def _gather_seq(x, group, size):
    """All-gather [B, L/S, D] chunks in rank order into [B, L, D]."""
    x = x.contiguous()
    out = torch.empty((size * x.shape[0],) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    torch.distributed.all_gather_into_tensor(out, x, group=group)
    out = out.reshape(size, *x.shape).transpose(0, 1)
    return out.reshape(x.shape[0], size * x.shape[1], *x.shape[2:])


def seq_single_source(it):
    """Under an installed seq mesh of size S > 1, ``embed``'s intermediates
    that come from data (tokens, e, e0, context, MPM tokens) replaced by
    seq rank 0's: the Ulysses sequence is cut from one input, as JAX cuts
    one global array, and every rank's TeaCache decides on the same e0.
    Each rank computed its own copy, which can differ from rank 0's in its
    last bits (its convolutions may run other cuDNN plans). Inference
    only: the sequence-parallel DiT has no backward (the trainers install
    no seq mesh)."""
    from ..parallel.mesh import broadcast_from_first
    from ..parallel.ulysses import get_mesh, seq_parallel_size

    if seq_parallel_size() == 1:
        return it
    fields = ("tokens", "e", "e0", "context", "mpm_tokens")
    if any(getattr(it, f) is not None and getattr(it, f).requires_grad
           for f in fields):
        raise NotImplementedError("the sequence-parallel DiT runs without "
                                  "a gradient (torch.no_grad)")
    new = broadcast_from_first([getattr(it, f) for f in fields],
                               get_mesh().get_group("seq"))
    return dataclasses.replace(it, **dict(zip(fields, new)))


def seq_shard(it, mpm, mask):
    """This rank's part of the block stack's inputs under an installed seq
    mesh of size S, and the function that gathers the stack's output: the
    tokens, RoPE rows, per-token modulation, MPM tokens and mask (seq rank
    0's, ``seq_single_source``) padded to a multiple of S (the padded keys
    lie past ``kv_lens``) and cut into S chunks in rank order, as the
    reference chunks them (wan_transformer4d.py:1187-1198). Without a seq
    mesh: the inputs as they are and the identity."""
    from ..parallel.ulysses import get_mesh, seq_parallel_size

    whole = (it.tokens, it.e0, it.rope_cos, it.rope_sin, mpm, mask)
    s = seq_parallel_size()
    if s == 1:
        return whole, lambda x: x
    mesh = get_mesh()
    rank = mesh.get_local_rank("seq")
    length = it.tokens.shape[1]
    per = -(-length // s)

    def part(t, dim):
        if t is None:
            return None
        if per * s > length:
            pad = [0, 0] * (t.dim() - 1 - dim) + [0, per * s - length]
            t = F.pad(t, pad)
        return t.narrow(dim, rank * per, per)

    local = (part(it.tokens, 1),
             part(it.e0, 1) if it.e0.dim() == 4 else it.e0,
             part(it.rope_cos, 0), part(it.rope_sin, 0), part(mpm, 1),
             part(mask, 0))
    group = mesh.get_group("seq")
    return local, lambda x: _gather_seq(x, group, s)[:, :length]


class SelfAttention(nn.Module):
    """qk RMSNorm over the full width with 3-axis RoPE (one K5 pass each
    for q and k), flash attention with kv-length masking."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        for name in ("q", "k", "v", "o"):
            setattr(self, name, Linear(cfg.dim, cfg.dim, cfg.dtype))
        if cfg.qk_norm:
            self.norm_q = RMSNorm(cfg.dim, cfg.eps, cfg.dtype)
            self.norm_k = RMSNorm(cfg.dim, cfg.eps, cfg.dtype)

    def forward(self, x, rope_cos, rope_sin, kv_lens):
        cfg = self.cfg
        b, l, _ = x.shape
        q, k, v = self.q(x), self.k(x), self.v(x)
        shape = (b, l, cfg.num_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = self.norm_q(q, rope_cos, rope_sin).reshape(shape)
            k = self.norm_k(k, rope_cos, rope_sin).reshape(shape)
        else:
            q = apply_rope(q.reshape(shape), rope_cos, rope_sin)
            k = apply_rope(k.reshape(shape), rope_cos, rope_sin)
        # the remat policies' names: 'flash' keeps the post-RoPE q, k, v
        # and every 'flash*' policy K1's (o, lse) ("sa")
        q = checkpoint_name(q, "sa_q")
        k = checkpoint_name(k, "sa_k")
        v = checkpoint_name(v.reshape(shape), "sa_v")
        o = attention(q, k, v, kv_lens=kv_lens, name="sa",
                      sequence_parallel=True)
        return self.o(o.reshape(b, l, cfg.dim))


class CrossAttention(nn.Module):
    """t2v/i2v cross attention. The zero-padded text keys are not masked
    (the JAX package passes no kv_lens here either)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        names = ["q", "k", "v", "o"]
        if cfg.model_type == "i2v":
            names += ["k_img", "v_img"]
        for name in names:
            setattr(self, name, Linear(cfg.dim, cfg.dim, cfg.dtype))
        if cfg.qk_norm:
            self.norm_q = RMSNorm(cfg.dim, cfg.eps, cfg.dtype)
            self.norm_k = RMSNorm(cfg.dim, cfg.eps, cfg.dtype)
            if cfg.model_type == "i2v":
                self.norm_k_img = RMSNorm(cfg.dim, cfg.eps, cfg.dtype)

    def forward(self, x, context):
        cfg = self.cfg
        b, l, _ = x.shape
        heads = (cfg.num_heads, cfg.head_dim)
        q = self.q(x)
        if cfg.qk_norm:
            q = self.norm_q(q)
        q = q.reshape(b, l, *heads)

        if cfg.model_type == "i2v":
            ctx_img = context[:, :cfg.clip_tokens]
            ctx_txt = context[:, cfg.clip_tokens:]
        else:
            ctx_img, ctx_txt = None, context

        k = self.k(ctx_txt)
        if cfg.qk_norm:
            k = self.norm_k(k)
        k = k.reshape(b, -1, *heads)
        v = self.v(ctx_txt).reshape(b, -1, *heads)
        o = attention(q, k, v)

        if ctx_img is not None:
            k_img = self.k_img(ctx_img)
            if cfg.qk_norm:
                k_img = self.norm_k_img(k_img)
            k_img = k_img.reshape(b, -1, *heads)
            v_img = self.v_img(ctx_img).reshape(b, -1, *heads)
            o = o + attention(q, k_img, v_img)
        return self.o(o.reshape(b, l, cfg.dim))


class SpatialGuidance(nn.Module):
    """Zero-initialised FiLM from MPM features. ``mask`` ([L, 1] float)
    marks tokens with real features; beyond them scale/shift are zero (the
    projection bias included). The module gives the FiLM's operands; the
    block applies them with its adaLN modulation in one K5 pass
    (``kernels.rownorm.modulate``)."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.spatial_guide = nn.Sequential(
            nn.SiLU(), Linear(cfg.motion_feature_dim, 2 * cfg.dim, cfg.dtype))
        self.gate = nn.Parameter(torch.zeros(cfg.dim))

    def forward(self, features, mask=None):
        """(the projection [B, L, 2D] of the features, ``mask``, the gate
        [D] in the compute dtype)."""
        return (self.spatial_guide(features.to(self.cfg.dtype)), mask,
                compute_param(self, "gate", self.cfg.dtype))


class WanBlock(nn.Module):
    """One DiT block: adaLN, (FiLM), self-attn, cross-attn, (FiLM), FFN."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.modulation = nn.Parameter(torch.zeros(1, 6, cfg.dim))
        self.self_attn = SelfAttention(cfg)
        self.cross_attn = CrossAttention(cfg)
        if cfg.cross_attn_norm:
            self.norm3 = LayerNormAffine(cfg.dim, cfg.eps)
        self.ffn = nn.Sequential(Linear(cfg.dim, cfg.ffn_dim, cfg.dtype),
                                 nn.GELU(approximate="tanh"),
                                 Linear(cfg.ffn_dim, cfg.dim, cfg.dtype))
        if cfg.motion_guidance:
            self.spatial_guidance_self = SpatialGuidance(cfg)
            self.spatial_guidance_ffn = SpatialGuidance(cfg)

    def forward(self, x, e0, context, rope_cos, rope_sin, kv_lens,
                mpm_tokens, mpm_mask):
        cfg = self.cfg
        # e0: [B, 6, D] (per-sample t) or [B, L, 6, D] (per-token t)
        if e0.dim() == 4:
            e = self.modulation[None].float() + e0.float()
        else:
            e = (self.modulation.float() + e0.float())[:, None]
        shift_sa, scale_sa, gate_sa, shift_ff, scale_ff, gate_ff = [
            e[..., i, :].to(cfg.dtype) for i in range(6)]

        film = (self.spatial_guidance_self(mpm_tokens, mpm_mask)
                if cfg.motion_guidance else None)
        h = modulate(x, cfg.eps, shift_sa, scale_sa, film)
        x = x + self.self_attn(h, rope_cos, rope_sin, kv_lens) * gate_sa

        h = self.norm3(x) if cfg.cross_attn_norm else x
        x = x + self.cross_attn(h, context)

        film = (self.spatial_guidance_ffn(mpm_tokens, mpm_mask)
                if cfg.motion_guidance else None)
        h = modulate(x, cfg.eps, shift_ff, scale_ff, film)
        # 'flash_ffn' keeps fc1's output
        hidden = checkpoint_name(self.ffn[0](h), "ffn_hidden")
        return x + self.ffn[2](self.ffn[1](hidden)) * gate_ff


class Head(nn.Module):
    """Output head with 2-way adaLN."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.modulation = nn.Parameter(torch.zeros(1, 2, cfg.dim))
        self.head = Linear(cfg.dim, math.prod(cfg.patch_size) * cfg.out_dim,
                           cfg.dtype)

    def forward(self, x, e):
        cfg = self.cfg
        ef = e.float()
        if e.dim() == 3:                                      # [B, L, D]
            m = self.modulation[None].float() + ef[:, :, None]
        else:                                                 # [B, D]
            m = (self.modulation.float() + ef[:, None])[:, None]
        shift, scale = [m[..., i, :].to(cfg.dtype) for i in range(2)]
        return self.head(layer_norm(x, cfg.eps) * (1 + scale) + shift)


@dataclasses.dataclass
class DiTIntermediates:
    """Carries embed-stage outputs into backbone/finalize."""

    tokens: torch.Tensor          # [B, L, D]
    e: torch.Tensor               # [B, D] or [B, L, D]
    e0: torch.Tensor              # [B, 6, D] or [B, L, 6, D]
    context: torch.Tensor         # [B, Lc, D]
    rope_cos: torch.Tensor
    rope_sin: torch.Tensor
    kv_lens: Optional[torch.Tensor]
    mpm_tokens: Optional[torch.Tensor]
    mpm_mask: Optional[torch.Tensor]
    grid: Tuple[int, int, int]
    ref_tokens: int


class WanDiT(nn.Module):
    """The Wan video DiT. ``cfg.motion_guidance`` selects the 4D variant."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.dim, cfg.dtype
        self.patch_embedding = Conv3d(cfg.in_dim, d, cfg.patch_size,
                                      stride=cfg.patch_size, dtype=dt)
        self.text_embedding = nn.Sequential(
            Linear(cfg.text_dim, d, dt), nn.GELU(approximate="tanh"),
            Linear(d, d, dt))
        # the time path runs in fp32
        self.time_embedding = nn.Sequential(
            Linear(cfg.freq_dim, d, torch.float32), nn.SiLU(),
            Linear(d, d, torch.float32))
        self.time_projection = nn.Sequential(
            nn.SiLU(), Linear(d, 6 * d, torch.float32))
        if cfg.model_type == "i2v":
            self.img_emb = nn.Module()
            self.img_emb.proj = nn.Sequential(
                LayerNormF32(cfg.clip_dim), Linear(cfg.clip_dim, cfg.clip_dim, dt),
                nn.GELU(), Linear(cfg.clip_dim, d, dt), LayerNormF32(d))
        ps = cfg.patch_size[1:]
        if cfg.control_adapter:
            self.control_adapter = Conv2d(cfg.control_adapter_dim, d, ps,
                                          stride=ps, dtype=dt)
        if cfg.ref_conv:
            self.ref_conv = Conv2d(cfg.ref_conv_dim, d, ps, stride=ps,
                                   dtype=dt)
        if cfg.motion_guidance:
            fd = cfg.motion_feature_dim
            self.feature_adapter = nn.Sequential(
                Conv2d(fd, fd, 3, padding=1, dtype=dt), nn.SiLU(),
                Conv2d(fd, fd, 3, padding=1, dtype=dt))
        self.blocks = nn.ModuleList(WanBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.head = Head(cfg)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "WanDiT":
        """Random weights from ``generator`` with the JAX package's
        initializers: xavier-uniform projections and convs, N(0, 0.02)
        text/time MLPs, N(0, dim^-1/2) modulation tables, zero output head
        and zero FiLM (an identity until trained), unit norms, zero
        biases."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "modulation":
                p.normal_(0.0, self.cfg.dim ** -0.5, generator=generator)
            elif leaf == "gate" or name.startswith("head.head") or \
                    ".spatial_guide." in name:
                p.zero_()
            elif leaf == "bias":
                p.zero_()
            elif p.dim() == 1:                        # norm scales
                p.fill_(1.0)
            elif name.startswith(("text_embedding", "time_embedding")):
                p.normal_(0.0, 0.02, generator=generator)
            else:
                nn.init.xavier_uniform_(p, generator=generator)
        return self

    @spanned("more4d.dit.embed")
    def embed(self, x, t, context, *, y=None, y_camera=None, clip_fea=None,
              full_ref=None, mpm_features=None, mpm_cls=None, seq_len=None,
              rope_tables: Optional[RopeTables] = None) -> DiTIntermediates:
        """Everything before the block stack.

        x: noisy latents [B, T, H, W, C_noise]; y: conditioning latents
        [B, T, H, W, C_cond] concatenated channel-wise; context: text
        embeddings [B, text_len, text_dim]; clip_fea: [B, 257, clip_dim];
        full_ref: [B, H, W, ref_dim]; mpm_features: [B, 196, feat_dim]; t:
        [B] or [B, L] timesteps.
        """
        cfg = self.cfg
        dev = x.device
        if y is not None:
            x = torch.cat([x, y.to(x.dtype)], dim=-1)
        b = x.shape[0]
        x = self.patch_embedding(x.permute(0, 4, 1, 2, 3))   # [B, D, f, h, w]
        if cfg.control_adapter and y_camera is not None:
            bb, tt2, hh2, ww2, cc2 = y_camera.shape
            cam = self.control_adapter(
                y_camera.reshape(bb * tt2, hh2, ww2, cc2).permute(0, 3, 1, 2))
            cam = cam.reshape(bb, tt2, cfg.dim, cam.shape[2], cam.shape[3])
            x = x + cam.permute(0, 2, 1, 3, 4)
        f, h, w = x.shape[2:]
        grid = (f, h, w)
        tokens = x.flatten(2).transpose(1, 2)                 # [B, fhw, D]

        ref_tokens = 0
        if cfg.ref_conv and full_ref is not None:
            ref = self.ref_conv(full_ref.permute(0, 3, 1, 2))
            ref = ref.flatten(2).transpose(1, 2)
            ref_tokens = ref.shape[1]
            tokens = torch.cat([ref, tokens], dim=1)
            grid = (f + 1, h, w)

        true_len = tokens.shape[1]
        if seq_len is None:
            seq_len = true_len
        if seq_len < true_len:
            raise ValueError(f"seq_len {seq_len} < {true_len} tokens")
        if seq_len > true_len:
            tokens = F.pad(tokens, (0, 0, 0, seq_len - true_len))
        kv_lens = torch.full((b,), true_len, dtype=torch.int32, device=dev)

        if rope_tables is None:
            rope_tables = RopeTables.create(cfg.head_dim)
        rope_cos, rope_sin = rope_angles_3d(rope_tables, grid,
                                            seq_len=seq_len, device=dev)

        # MPM token grid (4D variant): feature position 0 aligns with token
        # position 0 even when ref tokens are prepended; FiLM is zeroed past
        # the feature length through mpm_mask
        mpm_tokens, mpm_mask = None, None
        if cfg.motion_guidance and mpm_features is not None:
            fd = cfg.motion_feature_dim
            side = math.isqrt(mpm_features.shape[1])
            feats = mpm_features.reshape(b, side, side, fd).to(cfg.dtype)
            feats = self.feature_adapter(feats.permute(0, 3, 1, 2))
            feats = resize(feats.permute(0, 2, 3, 1), (b, h, w, fd))
            if cfg.use_cls_token and mpm_cls is not None:
                feats = mpm_cls[:, None, None, :].expand(b, h, w, fd).to(
                    cfg.dtype)
            feats = feats[:, None].expand(b, f, h, w, fd).reshape(
                b, f * h * w, fd)
            feat_len = feats.shape[1]
            if seq_len > feat_len:
                feats = F.pad(feats, (0, 0, 0, seq_len - feat_len))
            mpm_tokens = feats
            mpm_mask = (torch.arange(seq_len, device=dev) < feat_len).float(
            )[:, None]

        # timestep embedding (fp32)
        t = torch.as_tensor(t, device=dev)
        e, e0 = WanDiT.time_embed_e0(self, t)
        if t.dim() == 2:                      # per-token timesteps [B, L]
            e = e.reshape(b, seq_len, cfg.dim)
            e0 = e0.reshape(b, seq_len, 6, cfg.dim)
        else:
            e = e.reshape(b, cfg.dim)
            e0 = e0.reshape(b, 6, cfg.dim)

        # text context: pad to text_len, then MLP
        lc = context.shape[1]
        if lc < cfg.text_len:
            context = F.pad(context, (0, 0, 0, cfg.text_len - lc))
        ctx = self.text_embedding(context)

        if clip_fea is not None and cfg.model_type == "i2v":
            proj = self.img_emb.proj
            cf = proj[0](clip_fea)
            cf = proj[3](proj[2](proj[1](cf)))
            cf = proj[4](cf).to(cfg.dtype)
            ctx = torch.cat([cf, ctx], dim=1)

        return seq_single_source(DiTIntermediates(
            tokens=tokens, e=e, e0=e0, context=ctx, rope_cos=rope_cos,
            rope_sin=rope_sin, kv_lens=kv_lens, mpm_tokens=mpm_tokens,
            mpm_mask=mpm_mask, grid=grid, ref_tokens=ref_tokens))

    def time_embed_e0(self, t):
        """Timesteps (any shape) -> (e [N, D], e0 [N, 6, D]), the embed
        stage's adaLN projection alone, in fp32. e0 is TeaCache's decision
        statistic and depends on t only, so a whole schedule's decisions
        come from one call (``parallel/offload.py``)."""
        t = torch.as_tensor(t, device=self.time_projection[1].weight.device)
        emb = sinusoidal_embedding(self.cfg.freq_dim, t.reshape(-1))
        e = self.time_embedding(emb)
        return e, self.time_projection(e).reshape(-1, 6, self.cfg.dim)

    def remat_blocks(self) -> frozenset:
        """The indices of the blocks that ``cfg.remat`` rematerialises:
        ceil(remat_fraction * L) of them at stride L / n, evenly spaced as
        in the JAX package's unscanned block list."""
        cfg = self.cfg
        if not cfg.remat:
            return frozenset()
        saved_names(cfg.remat_policy)       # raises for an unknown policy
        n = int(math.ceil(cfg.remat_fraction * cfg.num_layers))
        stride = cfg.num_layers / max(n, 1)
        return frozenset(int(round(i * stride)) for i in range(n))

    @spanned("more4d.dit.backbone")
    def backbone(self, it: DiTIntermediates) -> torch.Tensor:
        """The block stack; returns the updated tokens. With ``cfg.remat``
        and a gradient being taken, the chosen blocks keep their input and
        what ``cfg.remat_policy`` names, and run again in the backward
        (``nn/remat.py``). Under an installed seq mesh each rank runs the
        blocks on its L/S tokens (``seq_shard``) and the stack's output is
        gathered whole, so TeaCache's residual and the head see the tokens
        they see without the mesh."""
        mpm, mask = zero_mpm_fallback(self.cfg, it.tokens, it.mpm_tokens,
                                      it.mpm_mask)
        remat = self.remat_blocks() if torch.is_grad_enabled() else ()
        runner = (Remat(self.cfg.remat_policy, it.tokens.device)
                  if remat else None)
        (x, e0, cos, sin, mpm, mask), gather = seq_shard(it, mpm, mask)
        for i, blk in enumerate(self.blocks):
            args = (x, e0, it.context, cos, sin, it.kv_lens, mpm, mask)
            x = runner.run(blk, *args) if i in remat else blk(*args)
        return gather(x)

    @spanned("more4d.dit.finalize")
    def finalize(self, tokens, it: DiTIntermediates) -> torch.Tensor:
        """Head + unpatchify back to [B, T, H, W, out_dim]."""
        cfg = self.cfg
        x = self.head(tokens, it.e)
        f, h, w = it.grid
        if it.ref_tokens:
            x = x[:, it.ref_tokens:]
            f = f - 1
        x = x[:, :f * h * w]
        pt, ph, pw = cfg.patch_size
        c = cfg.out_dim
        b = x.shape[0]
        x = x.reshape(b, f, h, w, pt, ph, pw, c)
        x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return x.reshape(b, f * pt, h * ph, w * pw, c)

    def forward(self, x, t, context, **kw):
        # the class's own methods: under FSDP2 (parallel.shard_params) the
        # instance's embed/finalize/time_embed_e0 are forward methods that
        # gather and release the root's parameters, which a call nested in
        # this forward would release before the backward reads them
        it = WanDiT.embed(self, x, t, context, **kw)
        return WanDiT.finalize(self, self.backbone(it), it)
