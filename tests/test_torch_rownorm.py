"""K5's plain versions and dispatch on the CPU (``kernels/rownorm.py``).

The plain versions are the DiT block's eager code moved behind K5's
wrapper, so each is held bit for bit (``torch.equal``) to the eager
composition the block ran before, written out here. The dispatchers send
a CPU tensor, and any call that carries a gradient, to the plain version;
only a CUDA tensor without one reaches the kernel (its tests are in
``test_torch_kernels_cuda.py``).
"""

import types

import numpy as np
import pytest
import torch

from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.kernels import rownorm
from more4d_tpu_torch.models.wan_dit import WanBlock
from more4d_tpu_torch.nn.attention import attention
from more4d_tpu_torch.nn import layers as tl
from more4d_tpu_torch.nn.rope import RopeTables, rope_angles_3d

B, D, HD = 2, 64, 16
GRID = (2, 3, 4)                     # 24 tokens, padded to 27
L = 27


def _bf16(*shape, seed=0, scale=1.0, shift=0.0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale
                            + shift).bfloat16()


# ------------------------------------------------- the eager code, as it was

def _eager_rms(x, weight, eps, dtype):
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (normed * weight.float()).to(dtype)


def _eager_rope(x, cos, sin):
    dtype = x.dtype
    b, l, n, d = x.shape
    xr = x.float().reshape(b, l, n, d // 2, 2)
    xe, xo = xr[..., 0], xr[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    oe = xe * c - xo * s
    oo = xe * s + xo * c
    return torch.stack([oe, oo], dim=-1).reshape(b, l, n, d).to(dtype)


def _eager_layer_norm(x, eps, weight=None, bias=None):
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def _eager_film(x, params, mask, gate):
    if mask is not None:
        params = params * mask[None].to(params.dtype)
    scale, shift = params.chunk(2, dim=-1)
    return x * (1 + scale * gate) + shift * gate


def _rope_rows():
    return rope_angles_3d(RopeTables.create(HD), GRID, seq_len=L)


def _mask(zero_from=20):
    return (torch.arange(L) < zero_from).float()[:, None]


@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_plain_is_the_eager_rms_norm(weight_dtype):
    x = _bf16(B, L, D, scale=3.0, shift=0.5)
    w = _bf16(D, seed=1, scale=0.1, shift=1.0).to(weight_dtype)
    want = _eager_rms(x, w, 1e-6, torch.bfloat16)
    assert torch.equal(rownorm.rms_norm(x, w, 1e-6, torch.bfloat16), want)
    assert torch.equal(rownorm.rms_norm_plain(x, w, 1e-6, torch.bfloat16),
                       want)


def test_rms_norm_rope_plain_is_norm_then_rope():
    """The self-attention's q: the norm rounded to bf16, then RoPE on its
    heads; the padding rows past f*h*w take the identity rotation."""
    x = _bf16(B, L, D, scale=2.0)
    w = _bf16(D, seed=1, scale=0.1, shift=1.0).float()
    cos, sin = _rope_rows()
    normed = _eager_rms(x, w, 1e-6, torch.bfloat16)
    want = _eager_rope(normed.reshape(B, L, D // HD, HD), cos, sin)
    got = rownorm.rms_norm(x, w, 1e-6, torch.bfloat16, cos, sin)
    assert got.shape == (B, L, D)
    assert torch.equal(got.reshape(want.shape), want)
    pad = slice(np.prod(GRID), L)
    assert torch.equal(got[:, pad], normed[:, pad])


def test_layer_norm_affine_plain_is_the_eager_layer_norm():
    x = _bf16(B, L, D, scale=3.0, shift=-1.0)
    w = _bf16(D, seed=1, scale=0.2, shift=1.0).float()
    b = _bf16(D, seed=2, scale=0.2).float()
    want = _eager_layer_norm(x, 1e-6, w, b)
    assert torch.equal(rownorm.layer_norm_affine(x, w, b, 1e-6), want)
    assert torch.equal(rownorm.layer_norm(x, 1e-6, w, b), want)


@pytest.mark.parametrize("film", ["none", "mask", "no_mask"])
@pytest.mark.parametrize("per_token", [False, True])
def test_modulate_plain_is_the_eager_adaln_and_film(film, per_token):
    """adaLN with per-sample [B, 1, D] or per-token [B, L, D] rows, then the
    FiLM (token mask rows at zero, or no mask) or none (the ViSM InP DiT)."""
    x = _bf16(B, L, D, scale=3.0, shift=0.5)
    rows = (B, L, D) if per_token else (B, 1, D)
    shift = _bf16(*rows, seed=1, scale=0.3)
    scale = _bf16(*rows, seed=2, scale=0.3)
    want = _eager_layer_norm(x, 1e-6) * (1 + scale) + shift
    operands = None
    if film != "none":
        params = _bf16(B, L, 2 * D, seed=3, scale=0.5)
        mask = _mask() if film == "mask" else None
        gate = _bf16(D, seed=4, scale=0.5)
        operands = (params, mask, gate)
        want = _eager_film(want, params, mask, gate)
    got = rownorm.modulate(x, 1e-6, shift, scale, operands)
    assert torch.equal(got, want)
    assert torch.equal(rownorm.modulate_plain(x, 1e-6, shift, scale,
                                              operands), want)


def test_modulate_film_rows_past_the_mask_are_the_adaln_alone():
    x = _bf16(B, L, D, scale=3.0)
    shift, scale = _bf16(B, 1, D, seed=1), _bf16(B, 1, D, seed=2)
    film = (_bf16(B, L, 2 * D, seed=3), _mask(20), _bf16(D, seed=4))
    got = rownorm.modulate(x, 1e-6, shift, scale, film)
    alone = rownorm.modulate(x, 1e-6, shift, scale)
    assert torch.equal(got[:, 20:], alone[:, 20:])
    assert not torch.equal(got[:, :20], alone[:, :20])


def _fake(cuda, requires_grad=False):
    return types.SimpleNamespace(is_cuda=cuda, requires_grad=requires_grad)


@pytest.mark.parametrize("cuda,grad_mode,requires_grad,kernel", [
    (False, False, False, False),      # a CPU tensor: the plain version
    (False, True, True, False),
    (True, False, False, True),        # no_grad on the card: K5
    (True, False, True, True),         # grad mode off: nothing recorded
    (True, True, False, True),         # nothing requires a gradient
    (True, True, True, False),         # a gradient: the eager code
])
def test_dispatch_rule(cuda, grad_mode, requires_grad, kernel):
    with torch.set_grad_enabled(grad_mode):
        assert rownorm._runs_kernel(_fake(cuda), _fake(cuda, requires_grad),
                                    None) == kernel


def test_dispatchers_pick_the_epilogue(monkeypatch):
    """With the rule granting the kernel, each dispatcher launches its
    epilogue once (the launcher stubbed)."""
    calls = []
    monkeypatch.setattr(rownorm, "_runs_kernel", lambda *a: True)
    monkeypatch.setattr(rownorm, "rownorm_cuda",
                        lambda epi, x, eps, **kw: calls.append(epi) or x)
    x = _bf16(B, L, D)
    w, v = torch.ones(D), _bf16(B, 1, D)
    cos, sin = _rope_rows()
    film = (_bf16(B, L, 2 * D), _mask(), _bf16(D))
    rownorm.rms_norm(x, w, 1e-6, torch.bfloat16)
    rownorm.rms_norm(x, w, 1e-6, torch.bfloat16, cos, sin)
    rownorm.layer_norm_affine(x, w, torch.zeros(D), 1e-6)
    rownorm.modulate(x, 1e-6, v, v)
    rownorm.modulate(x, 1e-6, v, v, film)
    assert calls == ["rms", "rope", "affine", "modulate", "film"]
    with pytest.raises(ValueError):          # the kernel writes bf16 only
        rownorm.rms_norm(x, w, 1e-6, torch.float32)


def test_a_gradient_takes_the_eager_code():
    x = _bf16(B, L, D).requires_grad_(True)
    w = torch.ones(D, requires_grad=True)
    before = rownorm.rownorm_cuda.launches
    y = rownorm.rms_norm(x, w, 1e-6, torch.bfloat16, *_rope_rows())
    y.float().square().sum().backward()
    assert x.grad is not None and w.grad is not None
    assert rownorm.rownorm_cuda.launches == before


@pytest.mark.parametrize("bad", ["cpu", "float32", "width", "epilogue"])
def test_the_launcher_refuses_what_the_kernel_cannot_take(bad):
    x = _bf16(B, L, D)
    epilogue = "rms"
    if bad == "float32":
        x = x.float()
    elif bad == "width":
        x = _bf16(B, L, 60)
    elif bad == "epilogue":
        epilogue = "swish"
    with pytest.raises(ValueError):
        rownorm.rownorm_cuda(epilogue, x, 1e-6, weight=torch.ones(D))


@pytest.mark.parametrize("motion_guidance", [True, False])
def test_block_routes_every_norm_through_the_dispatchers(monkeypatch,
                                                         motion_guidance):
    """One DiT block (i2v, qk norm, norm3) on the CPU: the same bits as the
    block's eager forward written out, and with the rule granting the
    kernel each site's epilogue once: 2 film (or modulate without motion
    guidance), 1 affine, 2 rope, 3 rms (cross q, text k, CLIP k)."""
    cfg = dit_tiny(model_type="i2v", motion_guidance=motion_guidance,
                   dtype=torch.bfloat16)
    torch.manual_seed(0)
    blk = WanBlock(cfg).bfloat16()
    for p in blk.parameters():
        p.data.normal_(0, 0.05)
    blk.requires_grad_(False)
    d = cfg.dim
    lc = cfg.clip_tokens + 7
    x = _bf16(B, L, d, scale=2.0)
    e0 = torch.from_numpy(np.random.RandomState(1).randn(B, 6, d)
                          .astype(np.float32) * 0.1)
    ctx = _bf16(B, lc, d, seed=2)
    cos, sin = rope_angles_3d(RopeTables.create(cfg.head_dim), GRID,
                              seq_len=L)
    mpm = _bf16(B, L, cfg.motion_feature_dim, seed=3)
    args = (x, e0, ctx, cos, sin, torch.full((B,), 24, dtype=torch.int32),
            mpm, _mask(24))
    got = blk(*args)

    calls = []

    def plain(epi, x, eps, **kw):
        calls.append(epi)
        return rownorm.rownorm_plain(epi, x, eps, **kw)

    monkeypatch.setattr(rownorm, "_runs_kernel", lambda *a: True)
    monkeypatch.setattr(rownorm, "rownorm_cuda", plain)
    assert torch.equal(blk(*args), got)
    site = "film" if motion_guidance else "modulate"
    assert sorted(calls) == sorted([site] * 2 + ["affine"] + ["rope"] * 2
                                   + ["rms"] * 3)
    monkeypatch.undo()

    # the eager block, written out as the module ran it before K5
    e = (blk.modulation.float() + e0.float())[:, None]
    sh_sa, sc_sa, g_sa, sh_ff, sc_ff, g_ff = [e[..., i, :].to(cfg.dtype)
                                              for i in range(6)]

    def film(sg, h):
        if not motion_guidance:
            return h
        params = sg.spatial_guide(mpm.to(cfg.dtype))
        return _eager_film(h, params, _mask(24), tl.compute_param(
            sg, "gate", cfg.dtype))

    sa, ca = blk.self_attn, blk.cross_attn
    h = film(getattr(blk, "spatial_guidance_self", None),
             _eager_layer_norm(x, cfg.eps) * (1 + sc_sa) + sh_sa)
    q = _eager_rms(sa.q(h), sa.norm_q.weight, cfg.eps, cfg.dtype)
    k = _eager_rms(sa.k(h), sa.norm_k.weight, cfg.eps, cfg.dtype)
    shape = (B, L, cfg.num_heads, cfg.head_dim)
    q = _eager_rope(q.reshape(shape), cos, sin)
    k = _eager_rope(k.reshape(shape), cos, sin)
    o = attention(q, k, sa.v(h).reshape(shape), kv_lens=args[5])
    xx = x + sa.o(o.reshape(B, L, d)) * g_sa
    h = _eager_layer_norm(xx, cfg.eps, blk.norm3.weight, blk.norm3.bias)
    xx = xx + ca(h, ctx)
    h = film(getattr(blk, "spatial_guidance_ffn", None),
             _eager_layer_norm(xx, cfg.eps) * (1 + sc_ff) + sh_ff)
    want = xx + blk.ffn[2](blk.ffn[1](blk.ffn[0](h))) * g_ff
    assert torch.equal(got, want)
