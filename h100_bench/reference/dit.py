"""The 4D-STraG DiT forward, classifier-free guidance and the flow-match
Euler loop in plain fp32 PyTorch.

The forward follows Wan2.1's DiT with MoRe4D's Motion Perception Module:
patch embedding (1x2x2) of [noise | conditioning] latents; the sinusoidal
time embedding, its MLP and the 6-way adaLN projection; the text MLP and
the CLIP projection, prepended to the text as context; per block adaLN,
the MPM FiLM (OmniMAE features through two 3x3 convolutions, resized
bilinearly onto the token grid), self-attention with RMS-normed q, k over
the full width and 3-axis RoPE, cross-attention to the text and CLIP keys
(each its own softmax, the two outputs added), the tanh-GELU FFN, and the
2-way adaLN head, unpatchified. Attention runs a block of query rows at a
time, so a 9,568-token self-attention fits.

``pr`` is the precision: ``pr.mm`` takes every product of two tensors
and ``pr.st`` every value the forward keeps (a projection's output, a
norm's, an attention's, the residual stream after each add). In fp32
(``FP32``) both are plain; the controls (``CONTROLS``) compute in fp8:
``FP8Products`` rounds the factors of every product to fp8 and every kept
value to bf16, as an fp8 GEMM with a bf16 output would; ``FP8Kept`` also
keeps the values in fp8, the places where the program keeps bf16.
Parameters come from ``weights(prefix)``, a function that gives a group's
fp32 tensors (the top with prefix "", each block as "blocks.<i>.") so a
large model can be made a block at a time.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

Weights = Callable[[str], Dict[str, torch.Tensor]]
SCORE_BYTES = 2 ** 30   # fp32 scores a block of the attention holds


class Precision:
    """Plain fp32: products and kept values as they are."""

    @staticmethod
    def mm(a, b):
        return a @ b

    @staticmethod
    def st(x):
        return x


FP32 = Precision()


def _straight(x, rounded):
    """``rounded`` forward, the gradient passed straight through to x."""
    return x + (rounded - x).detach()


class FP8Products(Precision):
    """The factors of every product rounded to fp8 with one scale a tensor
    (``fp8.scaled_e4m3``), every kept value to bf16."""

    @staticmethod
    def st(x):
        return _straight(x, x.detach().bfloat16().float())

    @staticmethod
    def mm(a, b):
        from .fp8 import scaled_e4m3

        return _straight(a, scaled_e4m3(a.detach())) @ \
            _straight(b, scaled_e4m3(b.detach()))


class FP8Kept(Precision):
    """The factors of every product and every value the forward keeps
    rounded to fp8 with one scale a tensor."""

    @staticmethod
    def st(x):
        from .fp8 import scaled_e4m3

        return _straight(x, scaled_e4m3(x.detach()))

    @classmethod
    def mm(cls, a, b):
        return cls.st(a) @ cls.st(b)


# the controls: the reference put in the program's place in the precision
# below the configuration's bf16 compute; each number's upper reading is
# the least of theirs
CONTROLS = {"fp8_products": FP8Products(), "fp8_kept": FP8Kept()}


def exact_fp32():
    """Plain fp32 products everywhere (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def linear(x, p, name, pr=FP32):
    return pr.st(pr.mm(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"])


def layer_norm(x, eps, weight=None, bias=None):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def gelu_exact(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def silu(x):
    return x * torch.sigmoid(x)


def attention(q, k, v, pr=FP32):
    """softmax(q k^T / sqrt(D)) v over [B, L, H, D], a block of query rows
    at a time (SCORE_BYTES of scores)."""
    scale = q.shape[-1] ** -0.5
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))   # B H L D
    b, h, _, _ = qh.shape
    rows = max(64, SCORE_BYTES // (4 * b * h * kh.shape[2]))
    outs = []
    for s in range(0, qh.shape[2], rows):
        scores = pr.mm(qh[:, :, s:s + rows], kh.transpose(-1, -2)) * scale
        outs.append(pr.mm(pr.st(torch.softmax(scores, dim=-1)), vh))
    return pr.st(torch.cat(outs, dim=2).permute(0, 2, 1, 3))


def rope_tables(head_dim, grid, device):
    """(cos, sin) [L, head_dim/2] fp32: the channel pairs split into
    temporal, height and width groups of d - 4(d//6), 2(d//6), 2(d//6)
    channels, angle = position x theta^(-2i/axis dim), theta 10^4, the
    angles in float64."""
    d = head_dim
    dims = (d - 4 * (d // 6), 2 * (d // 6), 2 * (d // 6))
    f, h, w = grid
    pos = np.stack(np.meshgrid(np.arange(f), np.arange(h), np.arange(w),
                               indexing="ij"), -1).reshape(-1, 3)
    ang = []
    for axis, da in enumerate(dims):
        freqs = 1.0 / np.power(10000.0, np.arange(0, da, 2) / da)
        ang.append(pos[:, axis:axis + 1].astype(np.float64) * freqs[None])
    ang = np.concatenate(ang, -1)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def apply_rope(x, cos, sin):
    """Rotate consecutive (even, odd) channel pairs of [B, L, H, D]."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([xe * c - xo * s, xe * s + xo * c], -1).flatten(-2)


def linear_resize_matrix(n_in, n_out, device):
    """[n_out, n_in] weights of linear interpolation at half-pixel
    centres with the edges held (an upsampling)."""
    src = (torch.arange(n_out, dtype=torch.float64) + 0.5) * n_in / n_out - 0.5
    src = src.clamp(0, n_in - 1)
    lo = src.floor().long()
    hi = torch.clamp(lo + 1, max=n_in - 1)
    frac = src - lo
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m[torch.arange(n_out), lo] += 1 - frac
    m[torch.arange(n_out), hi] += frac
    return m.float().to(device)


def embed(p, cfg, x, y, t, context, clip_fea, mpm, pr=FP32):
    """(tokens, e, e0, context tokens, MPM tokens, grid)."""
    d = cfg["dim"]
    b = x.shape[0]
    xin = torch.cat([x, y], -1)                             # B T H W C
    bt, tt, hh, ww, c = xin.shape
    pt, ph, pw = cfg["patch_size"]
    f, h, w = tt // pt, hh // ph, ww // pw
    patches = xin.reshape(b, f, pt, h, ph, w, pw, c).permute(
        0, 1, 3, 5, 7, 2, 4, 6).reshape(b, f * h * w, c * pt * ph * pw)
    tokens = pr.st(pr.mm(patches,
                         p["patch_embedding.weight"].reshape(d, -1).t())
                   + p["patch_embedding.bias"])

    half = cfg["freq_dim"] // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64,
                                             device=x.device) / half)
    arg = t.double()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(arg), torch.sin(arg)], -1).float()
    # the time path runs in fp32 whatever the precision
    e = linear(silu(linear(emb, p, "time_embedding.0")), p,
               "time_embedding.2")
    e0 = linear(silu(e), p, "time_projection.1").reshape(b, 6, d)

    ctx = linear(pr.st(gelu_tanh(linear(context, p, "text_embedding.0", pr))),
                 p, "text_embedding.2", pr)
    if cfg["model_type"] == "i2v":
        ci = layer_norm(clip_fea, cfg["eps"], p["img_emb.proj.0.weight"],
                        p["img_emb.proj.0.bias"])
        ci = linear(pr.st(gelu_exact(linear(ci, p, "img_emb.proj.1", pr))),
                    p, "img_emb.proj.3", pr)
        ci = pr.st(layer_norm(ci, cfg["eps"], p["img_emb.proj.4.weight"],
                              p["img_emb.proj.4.bias"]))
        ctx = torch.cat([ci, ctx], 1)

    mpm_tokens = None
    if cfg["motion_guidance"]:
        side = math.isqrt(mpm.shape[1])
        fd = cfg["motion_feature_dim"]
        fm = mpm.reshape(b, side, side, fd)
        for i in (0, 2):
            if i == 2:
                fm = silu(fm)
            cols = F.unfold(fm.permute(0, 3, 1, 2), 3, padding=1)  # B C*9 N
            wk = p[f"feature_adapter.{i}.weight"].reshape(fd, -1)
            fm = pr.st(pr.mm(cols.transpose(1, 2), wk.t())
                       + p[f"feature_adapter.{i}.bias"]).reshape(b, side,
                                                                 side, fd)
        rh = linear_resize_matrix(side, h, x.device)
        rw = linear_resize_matrix(side, w, x.device)
        fm = torch.einsum("ij,bjkc->bikc", rh, fm)
        fm = torch.einsum("ij,bkjc->bkic", rw, fm)
        mpm_tokens = pr.st(fm)[:, None].expand(b, f, h, w, fd).reshape(
            b, -1, fd)
    return tokens, e, e0, ctx, mpm_tokens, (f, h, w)


def film(hid, mpm_tokens, p, name, pr):
    params = linear(silu(mpm_tokens), p, f"{name}.spatial_guide.1", pr)
    scale, shift = params.chunk(2, -1)
    gate = p[f"{name}.gate"]
    return pr.st(hid * (1 + scale * gate) + shift * gate)


def block(p, cfg, x, e0, ctx, cos, sin, mpm_tokens, pr=FP32):
    """One DiT block on tokens ``x`` [B, L, D]."""
    b, l, d = x.shape
    nh = cfg["num_heads"]
    eps = cfg["eps"]
    e = (p["modulation"] + e0)[:, :, None]                  # B 6 1 D
    sh_sa, sc_sa, g_sa, sh_ff, sc_ff, g_ff = e.unbind(1)

    hid = pr.st(layer_norm(x, eps) * (1 + sc_sa) + sh_sa)
    if cfg["motion_guidance"]:
        hid = film(hid, mpm_tokens, p, "spatial_guidance_self", pr)
    q = pr.st(rms_norm(linear(hid, p, "self_attn.q", pr),
                       p["self_attn.norm_q.weight"], eps))
    k = pr.st(rms_norm(linear(hid, p, "self_attn.k", pr),
                       p["self_attn.norm_k.weight"], eps))
    v = linear(hid, p, "self_attn.v", pr)
    q, k, v = (t.reshape(b, l, nh, d // nh) for t in (q, k, v))
    o = attention(pr.st(apply_rope(q, cos, sin)),
                  pr.st(apply_rope(k, cos, sin)), v, pr)
    x = pr.st(x + linear(o.reshape(b, l, d), p, "self_attn.o", pr) * g_sa)

    hid = pr.st(layer_norm(x, eps, p["norm3.weight"], p["norm3.bias"]))
    q = pr.st(rms_norm(linear(hid, p, "cross_attn.q", pr),
                       p["cross_attn.norm_q.weight"], eps)).reshape(b, l, nh,
                                                                    -1)
    n_img = cfg["clip_tokens"] if cfg["model_type"] == "i2v" else 0
    txt, img = ctx[:, n_img:], ctx[:, :n_img]
    k = pr.st(rms_norm(linear(txt, p, "cross_attn.k", pr),
                       p["cross_attn.norm_k.weight"], eps))
    v = linear(txt, p, "cross_attn.v", pr)
    o = attention(q, k.reshape(b, -1, nh, d // nh),
                  v.reshape(b, -1, nh, d // nh), pr)
    if n_img:
        k = pr.st(rms_norm(linear(img, p, "cross_attn.k_img", pr),
                           p["cross_attn.norm_k_img.weight"], eps))
        v = linear(img, p, "cross_attn.v_img", pr)
        o = pr.st(o + attention(q, k.reshape(b, -1, nh, d // nh),
                                v.reshape(b, -1, nh, d // nh), pr))
    x = pr.st(x + linear(o.reshape(b, l, d), p, "cross_attn.o", pr))

    hid = pr.st(layer_norm(x, eps) * (1 + sc_ff) + sh_ff)
    if cfg["motion_guidance"]:
        hid = film(hid, mpm_tokens, p, "spatial_guidance_ffn", pr)
    hid = linear(pr.st(gelu_tanh(linear(hid, p, "ffn.0", pr))), p, "ffn.2",
                 pr)
    return pr.st(x + hid * g_ff)


def head(p, cfg, x, e, grid, pr=FP32):
    m = p["head.modulation"] + e[:, None]                   # B 2 D
    shift, scale = m[:, 0:1], m[:, 1:2]
    out = linear(pr.st(layer_norm(x, cfg["eps"]) * (1 + scale) + shift), p,
                 "head.head", pr)
    f, h, w = grid
    pt, ph, pw = cfg["patch_size"]
    c = cfg["out_dim"]
    b = x.shape[0]
    out = out.reshape(b, f, h, w, pt, ph, pw, c).permute(0, 1, 4, 2, 5, 3,
                                                         6, 7)
    return out.reshape(b, f * pt, h * ph, w * pw, c)


def forward(weights: Weights, cfg, x, y, t, context, clip_fea, mpm,
            pr=FP32, run_block=None):
    """The velocity [B, T', h, w, out_dim] at timesteps ``t`` [B].
    ``run_block(fn, *args)`` runs each block (the training reference
    passes a checkpoint)."""
    top = weights("")
    tokens, e, e0, ctx, mpm_tokens, grid = embed(top, cfg, x, y, t, context,
                                                 clip_fea, mpm, pr)
    cos, sin = rope_tables(cfg["dim"] // cfg["num_heads"], grid, x.device)
    for i in range(cfg["num_layers"]):
        bp = weights(f"blocks.{i}.")
        if run_block is None:
            tokens = block(bp, cfg, tokens, e0, ctx, cos, sin, mpm_tokens, pr)
        else:
            tokens = run_block(block, bp, cfg, tokens, e0, ctx, cos, sin,
                               mpm_tokens, pr)
        del bp
    return head(top, cfg, tokens, e, grid, pr)


def euler_sigmas(steps: int, shift: float, train_steps: int = 1000):
    """The flow-match Euler schedule: linspace(1, 1/T) warped by the shift
    s' = shift s / (1 + (shift - 1) s), then a final 0, in fp32."""
    s = np.linspace(1.0, 1.0 / train_steps, steps)
    s = shift * s / (1 + (shift - 1) * s)
    return np.concatenate([s, [0.0]]).astype(np.float32)


@torch.no_grad()
def denoise(weights: Weights, cfg, req, steps: int, shift: float,
            guidance: float, pr=FP32):
    """One request's final latents: ``steps`` Euler steps of the
    CFG-doubled forward (negative prompt first), guidance
    u + g (c - u), from ``req['x']``."""
    sig = euler_sigmas(steps, shift)
    x = req["x"].float()
    ctx = torch.cat([req["neg_context"], req["context"]])

    def two(a):
        return torch.cat([a, a])

    for i in range(steps):
        t = torch.full((2,), float(sig[i]) * 1000.0, device=x.device)
        v = forward(weights, cfg, two(x), two(req["y"]), t, ctx,
                    two(req["clip_fea"]), two(req["mpm_features"]), pr)
        u, c = v.chunk(2)
        v = u + guidance * (c - u)
        x = x + float(sig[i + 1] - sig[i]) * v
    return x
