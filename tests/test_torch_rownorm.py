"""K5's plain versions and dispatch on the CPU (``kernels/rownorm.py``).

The plain versions are the DiT block's eager code moved behind K5's
wrapper, so each is held bit for bit (``torch.equal``) to the eager
composition the block ran before, written out here. The dispatchers send
a CPU tensor to the plain version; a CUDA tensor goes to the kernel, or,
where autograd records, to ``RowNorm``, K5 with its backward (their tests
on the card are in ``test_torch_kernels_cuda.py``). The backward's plain
version is held to autograd of the plain chains, and ``RowNorm``'s wiring
(which gradients, in which order, under a checkpoint) is driven here
with CPU tensors, where it runs the plain versions.
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
from more4d_tpu_torch.nn.remat import Remat
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


@pytest.mark.parametrize("cuda,grad_mode,requires_grad,route", [
    (False, False, False, "plain"),    # a CPU tensor: the plain version
    (False, True, True, "plain"),
    (True, False, False, "kernel"),    # no_grad on the card: K5
    (True, False, True, "kernel"),     # grad mode off: nothing recorded
    (True, True, False, "kernel"),     # nothing requires a gradient
    (True, True, True, "grad"),        # a gradient: K5 and its backward
])
def test_dispatch_rule(cuda, grad_mode, requires_grad, route):
    with torch.set_grad_enabled(grad_mode):
        assert rownorm._route(_fake(cuda), _fake(cuda, requires_grad),
                              None) == route


def test_dispatchers_pick_the_epilogue(monkeypatch):
    """With the rule granting the kernel, each dispatcher launches its
    epilogue once (the launcher stubbed)."""
    calls = []
    monkeypatch.setattr(rownorm, "_route", lambda *a: rownorm.KERNEL)
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

    monkeypatch.setattr(rownorm, "_route", lambda *a: rownorm.KERNEL)
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


# ------------------------------------------------------------------ backward

def _operands(epilogue, dtype, *, per_token=False, film="mask",
              weight_dtype=torch.float32, seed=0):
    """x [B, L, D] in ``dtype`` and the operands of ``epilogue``: the norm's
    weight and bias in ``weight_dtype``, adaLN rows per sample or per
    token, the FiLM with its mask rows at zero (``film`` "mask") or
    without a mask ("no_mask")."""
    def t(*shape, s=1.0, m=0.0, k=0):
        return (_bf16(*shape, seed=seed + k, scale=s, shift=m).float()
                .to(dtype))
    x = t(B, L, D, s=3.0, m=0.5)
    kw = {}
    if epilogue in ("rms", "rope", "affine"):
        kw["weight"] = t(D, s=0.2, m=1.0, k=1).to(weight_dtype)
    if epilogue == "affine":
        kw["bias"] = t(D, s=0.2, k=2).to(weight_dtype)
    if epilogue == "rope":
        kw["cos"], kw["sin"] = _rope_rows()
    if epilogue in ("modulate", "film"):
        rows = (B, L, D) if per_token else (B, 1, D)
        kw["shift"], kw["scale"] = t(*rows, s=0.3, k=3), t(*rows, s=0.3, k=4)
    if epilogue == "film":
        kw["film"] = (t(B, L, 2 * D, s=0.5, k=5),
                      _mask() if film == "mask" else None,
                      t(D, s=0.5, k=6))
    return x, kw


def _chain(epilogue, x, kw):
    """The plain chain of ``epilogue`` in x's dtype (fp32 rounds nowhere)."""
    if epilogue == "rms":
        return rownorm.rms_norm_plain(x, kw["weight"], 1e-6, x.dtype)
    if epilogue == "rope":
        return rownorm.rms_norm_rope_plain(x, kw["weight"], 1e-6, x.dtype,
                                           kw["cos"], kw["sin"])
    if epilogue == "affine":
        return rownorm.layer_norm(x, 1e-6, kw["weight"], kw["bias"])
    return rownorm.modulate_plain(x, 1e-6, kw["shift"], kw["scale"],
                                  kw.get("film"))


def _taped(x, kw, frozen=()):
    """Leaf copies of x and the operands recording a gradient (but the
    names in ``frozen``), and {name: leaf} of those that take one."""
    def leaf(v, name):
        return v.detach().clone().requires_grad_(name not in frozen)
    xt, kt = leaf(x, "x"), {}
    leaves = {"x": xt}
    for k, v in kw.items():
        if k == "film":
            params, gate = leaf(v[0], "params"), leaf(v[2], "gate")
            kt[k] = (params, v[1], gate)
            leaves.update(params=params, gate=gate)
        elif k in ("cos", "sin"):
            kt[k] = v
        else:
            kt[k] = leaves[k] = leaf(v, k)
    return xt, kt, leaves


BWD_CASES = [
    ("rms", {}), ("rms", {"weight_dtype": torch.bfloat16}),
    ("rope", {}), ("rope", {"weight_dtype": torch.bfloat16}),
    ("affine", {}), ("affine", {"weight_dtype": torch.bfloat16}),
    ("modulate", {}), ("modulate", {"per_token": True}),
    ("film", {}), ("film", {"per_token": True}), ("film", {"film": "no_mask"}),
]
BWD_IDS = [e + "".join(f"-{v if isinstance(v, str) else k}"
                       for k, v in o.items()) for e, o in BWD_CASES]


@pytest.mark.parametrize("epilogue,opts", BWD_CASES, ids=BWD_IDS)
def test_backward_plain_is_autograd_of_the_plain_chain(epilogue, opts):
    """In fp32 the plain chains round nowhere, so autograd of a chain and
    the backward's mathematics written out agree to fp32's rounding (a
    bf16-stored weight's gradient to one bf16 rounding of the same sum);
    every gradient in its operand's dtype and shape."""
    x, kw = _operands(epilogue, torch.float32, **opts)
    xt, kt, leaves = _taped(x, kw)
    dy = _bf16(*x.shape, seed=9).float()
    _chain(epilogue, xt, kt).backward(dy)
    got = rownorm.rownorm_backward_plain(
        epilogue, x, dy, rownorm.row_stats(epilogue, x, 1e-6), **kw)
    assert set(got) == set(leaves)
    for name, leaf in leaves.items():
        want = leaf.grad
        assert got[name].dtype == want.dtype and got[name].shape == want.shape
        top = want.float().abs().max().item()
        tol = top * (2 ** -8 if want.dtype == torch.bfloat16 else 1e-5)
        assert (got[name].float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("epilogue", rownorm.EPILOGUES)
def test_backward_plain_gives_only_what_is_asked_for(epilogue):
    """``need`` a subset (ViSM LoRA: the norm's weights and the adaLN rows
    frozen): those gradients alone, the same as when all are asked for."""
    x, kw = _operands(epilogue, torch.float32)
    dy = _bf16(*x.shape, seed=9).float()
    stats = rownorm.row_stats(epilogue, x, 1e-6)
    every = rownorm.rownorm_backward_plain(epilogue, x, dy, stats, **kw)
    need = {"x", "params", "gate"}
    some = rownorm.rownorm_backward_plain(epilogue, x, dy, stats, need=need,
                                          **kw)
    assert set(some) == need & set(every)
    for name, t in some.items():
        assert torch.equal(t, every[name])


@pytest.mark.parametrize("epilogue,opts", BWD_CASES, ids=BWD_IDS)
def test_rownorm_function_gives_the_backwards_gradients(epilogue, opts):
    """``RowNorm`` on bf16 CPU tensors: its output the plain version's
    bits; each operand's gradient the plain backward's from
    :func:`row_stats` (the wiring: which input gets which), within 2% of
    autograd of the bf16 chain (which rounds after every operation); no
    gradient for a frozen operand."""
    x, kw = _operands(epilogue, torch.bfloat16, **opts)
    kw = {k: (v.to(opts.get("weight_dtype", torch.float32))
              if k in ("weight", "bias") else v) for k, v in kw.items()}
    dy = _bf16(*x.shape, seed=9)
    frozen = ("weight", "shift") if epilogue != "rms" else ()
    xt, kt, leaves = _taped(x, kw, frozen)
    params, mask, gate = kt.get("film", (None, None, None))
    out = rownorm.RowNorm.apply(
        epilogue, xt, 1e-6, kt.get("weight"), kt.get("bias"),
        kt.get("shift"), kt.get("scale"), params, mask, gate, kt.get("cos"),
        kt.get("sin"))
    assert torch.equal(out, rownorm.rownorm_plain(epilogue, x, 1e-6, **kw))
    stats = rownorm.row_stats(epilogue, x, 1e-6)
    out.backward(dy)
    want = rownorm.rownorm_backward_plain(epilogue, x, dy, stats, **kw)
    et, ekt, eager = _taped(x, kw)
    rownorm.rownorm_plain(epilogue, et, 1e-6, **ekt).backward(dy)
    for name, leaf in leaves.items():
        if name in frozen:
            assert leaf.grad is None
            continue
        assert torch.equal(leaf.grad, want[name]), name
        e = eager[name].grad.float()
        assert ((leaf.grad.float() - e).norm() / e.norm()).item() < 2e-2


def _recorded_to_rownorm(x, *more):
    """The card's rule on the CPU: a call autograd records takes
    ``RowNorm``."""
    recorded = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *more))
    return rownorm.GRAD if recorded else rownorm.PLAIN


@pytest.mark.parametrize("policy", [None, "nothing", "dots", "flash"])
def test_a_block_takes_rownorm_under_every_remat_policy(monkeypatch, policy):
    """One DiT block (i2v, motion guidance) with every call that autograd
    records sent to ``RowNorm``, as on the card, on the CPU: 8 forwards a
    run of the block (16 rematerialised: the forward and the backward's
    run) and 8 backwards; the gradients of x and every parameter within 1%
    of the eager block's, and under a remat policy the bits of the block
    without one."""
    cfg = dit_tiny(model_type="i2v", motion_guidance=True,
                   dtype=torch.bfloat16)
    torch.manual_seed(0)
    blk = WanBlock(cfg)
    for p in blk.parameters():
        p.data.normal_(0, 0.05)
    for m in blk.modules():
        if hasattr(m, "eps") and hasattr(m, "weight"):
            m.weight.data += 1.0
    d = cfg.dim
    x = _bf16(B, L, d, scale=2.0)
    cos, sin = rope_angles_3d(RopeTables.create(cfg.head_dim), GRID,
                              seq_len=L)
    args = (torch.from_numpy(np.random.RandomState(1).randn(B, 6, d)
                             .astype(np.float32) * 0.1),
            _bf16(B, cfg.clip_tokens + 7, d, seed=2), cos, sin,
            torch.full((B,), 24, dtype=torch.int32),
            _bf16(B, L, cfg.motion_feature_dim, seed=3), _mask(24))

    def grads(remat):
        blk.zero_grad()
        xt = x.clone().requires_grad_(True)
        out = (blk(xt, *args) if remat is None else
               Remat(remat, torch.device("cpu")).run(blk, xt, *args))
        out.float().square().mean().backward()
        return [xt.grad] + [p.grad for p in blk.parameters()]

    eager = grads(policy)
    calls = {"forward": 0, "backward": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(rownorm, "_route", _recorded_to_rownorm)
    monkeypatch.setattr(rownorm, "row_stats",       # once a CPU forward
                        counted("forward", rownorm.row_stats))
    monkeypatch.setattr(rownorm, "rownorm_backward_plain",
                        counted("backward", rownorm.rownorm_backward_plain))
    got = grads(policy)
    assert calls == {"forward": 8 if policy is None else 16,
                     "backward": 8}
    num = sum((a.float() - b.float()).square().sum()
              for a, b in zip(got, eager))
    den = sum(b.float().square().sum() for b in eager)
    assert (num / den).sqrt().item() < 1e-2
    if policy is not None:
        bare = grads(None)
        assert all(torch.equal(a, b) for a, b in zip(got, bare))


@pytest.mark.parametrize("group_rows,groups,occupancy,sms", [
    (9568, 1, 4, 132), (9568, 2, 3, 132), (37, 2, 4, 132), (1, 1, 8, 132),
    (1000, 7, 2, 16),
])
def test_backward_strips_cover_every_row_once(group_rows, groups, occupancy,
                                              sms):
    """The strips of each group: at least one row each, together every row
    once, and no more CTAs than one wave of the card holds (or one a
    row)."""
    strips = rownorm.bwd_strips(group_rows, groups, occupancy, sms)
    per = -(-group_rows // strips)
    assert (strips - 1) * per < group_rows <= strips * per
    assert strips <= max(-(-sms * occupancy // groups), 1)
    assert 1 <= strips <= group_rows
