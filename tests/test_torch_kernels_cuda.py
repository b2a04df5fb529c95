"""The port's CUDA kernels against their plain PyTorch versions, on a
card. These tests skip on a host without one. The file imports neither
JAX nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances: K1 (bf16) 2 bf16 ulps of the plain version's largest |O| on
O (both round O to bf16, so an element may differ by one rounding flip;
the kernel also rounds P to bf16 against the running max of each key
tile while the plain version uses the row's max), atol 1e-4 on the fp32
base-2 lse (only the order of sums differs); K2/K3 (bf16) 2 bf16 ulps of
the plain version's largest |dq|, |dk|, |dv| and a relative 2-norm of
2e-3 (both sides round the result once and P and dS once per term, at the
same points; only the order of the fp32 sums differs, so an element may
sit one rounding flip away, as for K1); masked keys get exactly zero dk
and dv; K4
(fp32) atol 1e-5 on colours and alpha in [0, 1] (the same formula, the
running product and sums ordered the same; the kernel's exp2 of c_k d2
with c_k = -0.5 log2(e) / s_k^2 moves a weight by ~1e-6 at most, as
csrc/gs_splat.cu sets out); K6 (fp8 -> bf16 and fp32) bit for bit, NaN for
NaN.
"""

import numpy as np
import pytest
import torch

from more4d_tpu_torch.geometry.projection import get_intrinsic_matrix
from more4d_tpu_torch.kernels.flash_attention import (
    _delta, _sm_count, dkv_splits, flash_attention, flash_attention_bwd_cuda,
    flash_attention_bwd_plain, flash_attention_cuda, flash_attention_plain,
    flash_bwd_dkv_cuda, flash_bwd_dq_cuda, scaled_q)
from more4d_tpu_torch.kernels.gs_splat import (gs_render_tiled, splat_cuda,
                                               splat_plain, tile_records)
from more4d_tpu_torch.kernels import rownorm
from more4d_tpu_torch.kernels.rownorm import (rms_norm, rownorm_bwd_cuda,
                                              rownorm_cuda, rownorm_plain)
from more4d_tpu_torch.kernels.widen import widen_fp8_cuda, widen_fp8_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _qkv(lq, lk, d, dev, heads=12, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(2, n, heads, d, device=dev, generator=g).bfloat16()
            for n in (lq, lk, lk)]


@pytest.mark.parametrize("lq,lk,d", [(17, 9, 128), (40, 24, 64),
                                     (300, 257, 128), (1000, 512, 128),
                                     (130, 1000, 64)])
def test_flash_kernel_matches_plain(dev, lq, lk, d):
    q, k, v = _qkv(lq, lk, d, dev)
    lens = torch.tensor([lk, max(lk // 2, 1)], dtype=torch.int32,
                        device=dev)
    for kv_lens in (None, lens):
        o, lse = flash_attention_cuda(q, k, v, kv_lens)
        o_ref, lse_ref = flash_attention_plain(q, k, v, kv_lens)
        torch.cuda.synchronize()
        top = o_ref.float().abs().max().item()
        tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)    # 2 bf16 ulps
        assert (o.float() - o_ref.float()).abs().max().item() <= tol
        assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("d", [64, 128])
def test_flash_kernel_ragged_tiles_under_kv_lens(dev, d):
    """Several q tiles of K1 with a ragged last one, and a ragged last key
    tile under each row's kv-length (200 and 131 keys of 200)."""
    q, k, v = _qkv(300, 200, d, dev, seed=9)
    lens = torch.tensor([200, 131], dtype=torch.int32, device=dev)
    o, lse = flash_attention_cuda(q, k, v, lens)
    o_ref, lse_ref = flash_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    top = o_ref.float().abs().max().item()
    tol = 2 * 2.0 ** (np.floor(np.log2(top)) - 7)        # 2 bf16 ulps
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # the masked keys take no part: other values there change nothing
    k2, v2 = k.clone(), v.clone()
    k2[1, 131:], v2[1, 131:] = 9.0, -9.0
    o2, lse2 = flash_attention_cuda(q, k2, v2, lens)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_kernel_is_deterministic(dev):
    q, k, v = _qkv(1000, 700, 128, dev, seed=10)
    lens = torch.tensor([700, 333], dtype=torch.int32, device=dev)
    first = flash_attention_cuda(q, k, v, lens)
    second = flash_attention_cuda(q, k, v, lens)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_flash_dispatch_launches_on_cuda(dev):
    q, k, v = _qkv(33, 20, 128, dev)
    before = flash_attention_cuda.launches
    out = flash_attention(q, k, v)
    assert flash_attention_cuda.launches == before + 1
    assert out.shape == q.shape
    with pytest.raises(ValueError):
        flash_attention(q.float(), k.float(), v.float())   # bf16 only
    with pytest.raises(ValueError):
        flash_attention(*_qkv(33, 20, 96, dev))             # D 64 or 128


def _bf16_ulps(x):
    """One bf16 ulp at the magnitude of x's largest element."""
    return 2.0 ** (np.floor(np.log2(x.float().abs().max().item())) - 7)


def _assert_backward_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        diff = (g.float() - w.float())
        assert diff.abs().max().item() <= 2 * _bf16_ulps(w), name
        assert (diff.norm() / w.float().norm()).item() <= 2e-3, name


@pytest.mark.parametrize("lq,lk,d", [(17, 9, 128), (40, 24, 64),
                                     (300, 257, 128), (130, 1000, 64),
                                     (200, 512, 128)])
def test_flash_backward_kernels_match_plain(dev, lq, lk, d):
    q, k, v = _qkv(lq, lk, d, dev, seed=1)
    do = _qkv(lq, 1, d, dev, seed=2)[0]
    lens = torch.tensor([lk, max(lk // 2, 1)], dtype=torch.int32,
                        device=dev)
    for kv_lens in (None, lens):
        o, lse = flash_attention_cuda(q, k, v, kv_lens)
        got = flash_attention_bwd_cuda(q, k, v, kv_lens, o, lse, do)
        want = flash_attention_bwd_plain(q, k, v, kv_lens, o, lse, do)
        torch.cuda.synchronize()
        _assert_backward_close(got, want)
        if kv_lens is not None:
            dk, dv = got[1], got[2]
            assert not dk[1, lens[1]:].any() and not dv[1, lens[1]:].any()


@pytest.mark.parametrize("lk", [512, 257])
def test_flash_backward_q_split_matches_plain(dev, lk):
    """Shapes whose 64-key CTAs do not fill the card, so K3 splits its q
    loop: the split (and the same kernel forced to one split) against the
    plain backward, with and without kv_lens."""
    lq = 2000
    q, k, v = _qkv(lq, lk, 128, dev, seed=5)
    do = _qkv(lq, 1, 128, dev, seed=6)[0]
    assert dkv_splits(2, 12, lq, lk, _sm_count(dev)) > 1
    lens = torch.tensor([lk, lk // 2 + 3], dtype=torch.int32, device=dev)
    for kv_lens in (None, lens):
        o, lse = flash_attention_cuda(q, k, v, kv_lens)
        want = flash_attention_bwd_plain(q, k, v, kv_lens, o, lse, do)
        got = flash_attention_bwd_cuda(q, k, v, kv_lens, o, lse, do)
        _assert_backward_close(got, want)
        one = flash_bwd_dkv_cuda(scaled_q(q, 128 ** -0.5), k, v, kv_lens, do,
                                 lse, _delta(o, do), splits=1)
        _assert_backward_close((got[0], *one), want)
        if kv_lens is not None:
            assert not got[1][1, lk // 2 + 3:].any()
            assert not got[2][1, lk // 2 + 3:].any()


@pytest.mark.parametrize("lq,lk", [(2000, 512), (1024, 1024)],
                         ids=["split", "self"])
def test_flash_backward_is_deterministic(dev, lq, lk):
    """K2 and K3 use no atomics, and the q-split sums its partials in a
    fixed order: two calls give the same bits."""
    q, k, v = _qkv(lq, lk, 128, dev, seed=7)
    do = _qkv(lq, 1, 128, dev, seed=8)[0]
    o, lse = flash_attention_cuda(q, k, v)
    first = flash_attention_bwd_cuda(q, k, v, None, o, lse, do)
    second = flash_attention_bwd_cuda(q, k, v, None, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_backward_masked_keys_are_ignored(dev):
    q, k, v = _qkv(70, 130, 128, dev, seed=3)
    do = _qkv(70, 1, 128, dev, seed=4)[0]
    lens = torch.tensor([130, 45], dtype=torch.int32, device=dev)
    o, lse = flash_attention_cuda(q, k, v, lens)
    dq, dk, dv = flash_attention_bwd_cuda(q, k, v, lens, o, lse, do)
    k2, v2 = k.clone(), v.clone()
    k2[1, 45:] = 7.0
    v2[1, 45:] = -7.0
    dq2, dk2, dv2 = flash_attention_bwd_cuda(q, k2, v2, lens, o, lse, do)
    torch.cuda.synchronize()
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2)
    assert torch.equal(dv, dv2)
    assert not dk[1, 45:].any() and not dv[1, 45:].any()


def test_flash_backward_dispatch_launches_on_cuda(dev):
    q, k, v = (x.requires_grad_() for x in _qkv(33, 20, 128, dev))
    before = (flash_attention_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    loss = flash_attention(q, k, v).float().square().sum()
    loss.backward()
    after = (flash_attention_cuda.launches, flash_bwd_dq_cuda.launches,
             flash_bwd_dkv_cuda.launches)
    assert after == tuple(n + 1 for n in before)
    for x in (q, k, v):
        assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()
    with torch.no_grad():
        flash_attention(q, k, v)          # inference: the forward alone
    assert flash_bwd_dq_cuda.launches == after[1]


def _cloud(n, seed, dev):
    rs = np.random.RandomState(seed)
    pts = np.stack([rs.uniform(-0.5, 0.5, n), rs.uniform(-0.35, 0.35, n),
                    rs.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    return (torch.from_numpy(pts).to(dev),
            torch.from_numpy(rs.rand(n, 3).astype(np.float32)).to(dev))


@pytest.mark.parametrize("max_per_tile", [512, 64])
def test_splat_kernel_matches_plain(dev, max_per_tile):
    h, w = 48, 64
    pts, cols = _cloud(8000, 1, dev)
    *rec, (_, tx) = tile_records(pts[None], cols, torch.eye(4, device=dev)
                                 [None], get_intrinsic_matrix(h, w, device=dev),
                                 h, w, scale=2e-2, max_per_tile=max_per_tile)
    img, alpha = splat_cuda(*rec, tx, 0.25)
    img_ref, alpha_ref = splat_plain(*rec, tx, 0.25)
    torch.cuda.synchronize()
    assert (img - img_ref).abs().max().item() < 1e-5
    assert (alpha - alpha_ref).abs().max().item() < 1e-5


@pytest.mark.parametrize("channels", [1, 4])
def test_splat_kernel_channels(dev, channels):
    h, w = 48, 64
    pts, _ = _cloud(6000, 3, dev)
    cols = torch.from_numpy(np.random.RandomState(4).rand(
        6000, channels).astype(np.float32)).to(dev)
    *rec, (_, tx) = tile_records(pts[None], cols, torch.eye(4, device=dev)
                                 [None], get_intrinsic_matrix(h, w, device=dev),
                                 h, w, scale=2e-2, max_per_tile=128)
    img, alpha = splat_cuda(*rec, tx, 0.5)
    img_ref, alpha_ref = splat_plain(*rec, tx, 0.5)
    torch.cuda.synchronize()
    assert img.shape == (1, h, w, channels)
    assert (img - img_ref).abs().max().item() < 1e-5
    assert (alpha - alpha_ref).abs().max().item() < 1e-5


def test_splat_kernel_empty_tile(dev):
    """A tile whose record count is 0 composites nothing, whatever its
    padding holds: the background alone, alpha 0."""
    h, w = 32, 48
    pts, cols = _cloud(4000, 5, dev)
    *rec, (_, tx) = tile_records(pts[None], cols, torch.eye(4, device=dev)
                                 [None], get_intrinsic_matrix(h, w, device=dev),
                                 h, w, scale=2e-2)
    assert int(rec[5][0, 1]) > 0
    rec[5][0, 1] = 0
    img, alpha = splat_cuda(*rec, tx, 0.25)
    img_ref, alpha_ref = splat_plain(*rec, tx, 0.25)
    torch.cuda.synchronize()
    assert (img - img_ref).abs().max().item() < 1e-5
    assert (alpha - alpha_ref).abs().max().item() < 1e-5
    tile = (slice(0, 16), slice(16, 32))            # tile 1: row 0, column 1
    assert torch.all(img[0][tile] == 0.25) and torch.all(alpha[0][tile] == 0)


def test_splat_entry_point_launches_on_cuda(dev):
    pts, cols = _cloud(3000, 2, dev)
    before = splat_cuda.launches
    img, alpha = gs_render_tiled(pts, cols, torch.eye(4, device=dev),
                                 get_intrinsic_matrix(32, 48, device=dev), 32,
                                 48)
    assert splat_cuda.launches == before + 1
    assert img.shape == (32, 48, 3) and alpha.shape == (32, 48)
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("policy", ["dots", "flash_lite", "flash",
                                    "flash_ffn", "flash_offload",
                                    "flash_lite_offload"])
def test_remat_policies_give_nothings_gradients_on_cuda(dev, policy):
    """A 3-block DiT (bf16 compute, fp32 params, 2 heads of 128) under each
    remat policy: the same loss and parameter gradients as 'nothing', bit
    for bit (a kept value is the one the backward's run would compute
    again, and the kernels are deterministic); K1 runs 6 times a block
    under 'nothing' and 'dots' (3 attentions in the forward and again in
    the backward's run), 5 under a 'flash*' policy (the backward's run
    skips the self-attention); K2 and K3 3 times a block."""
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.models import WanDiT

    kw = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=3, in_dim=16,
              out_dim=4, text_dim=32, clip_dim=32, text_len=16,
              motion_guidance=True, model_type="i2v", remat=True)
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(1, 3, 16, 16, 4, device=dev, generator=g)
    y = torch.randn(1, 3, 16, 16, 12, device=dev, generator=g)
    ctx = torch.randn(1, 16, 32, device=dev, generator=g)
    sd, out = None, {}
    for pol in ("nothing", policy):
        torch.manual_seed(0)
        with torch.device(dev):
            dit = WanDiT(dit_tiny(remat_policy=pol, **kw))
        if sd is None:
            dit.init_weights(torch.Generator(dev).manual_seed(1))
            with torch.no_grad():
                for name, p in dit.named_parameters():
                    if name.startswith("head.head") or name.endswith(
                            ".gate") or ".spatial_guide." in name:
                        p.normal_(0.0, 0.02, generator=g)
            sd = dit.state_dict()
        dit.load_state_dict(sd)
        clip = torch.randn(1, dit.cfg.clip_tokens, 32, device=dev,
                           generator=torch.Generator(dev).manual_seed(2))
        mpm = torch.randn(1, 196, dit.cfg.motion_feature_dim, device=dev,
                          generator=torch.Generator(dev).manual_seed(3))
        for c in (flash_attention_cuda, flash_bwd_dq_cuda,
                  flash_bwd_dkv_cuda):
            c.launches = 0
        loss = dit(x, torch.tensor([400.0], device=dev), ctx, y=y,
                   clip_fea=clip, mpm_features=mpm).float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        out[pol] = (loss.item(), {n: p.grad for n, p in
                                  dit.named_parameters()},
                    (flash_attention_cuda.launches,
                     flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches))
    assert out["nothing"][2] == (18, 9, 9)
    assert out[policy][2] == (18 if policy == "dots" else 15, 9, 9)
    assert out[policy][0] == out["nothing"][0]
    for name, grad in out["nothing"][1].items():
        assert torch.equal(out[policy][1][name], grad), name


# ----------------------------------------------------------------------- K5

def _rownorm_inputs(dev, epilogue, d, b=2, l=37, hd=128, seed=0,
                    per_token=False, mask=True):
    """x [b, l, d] bf16 and the operands of ``epilogue``: RoPE rows for a
    (1, 4, 8) grid padded to l tokens (identity rows past 32); FiLM mask
    rows at zero from token 30 on."""
    from more4d_tpu_torch.nn.rope import RopeTables, rope_angles_3d

    g = torch.Generator(dev).manual_seed(seed)

    def r(*shape, s=1.0, m=0.0):
        return (torch.randn(*shape, device=dev, generator=g) * s + m)

    x = r(b, l, d, s=3.0, m=0.5).bfloat16()
    kw = {}
    if epilogue in ("rms", "rope", "affine"):
        kw["weight"] = r(d, s=0.2, m=1.0)
    if epilogue == "affine":
        kw["bias"] = r(d, s=0.2)
    if epilogue == "rope":
        kw["cos"], kw["sin"] = rope_angles_3d(RopeTables.create(hd),
                                              (1, 4, 8), seq_len=l,
                                              device=dev)
    if epilogue in ("modulate", "film"):
        rows = (b, l, d) if per_token else (b, 1, d)
        kw["shift"] = r(*rows, s=0.3).bfloat16()
        kw["scale"] = r(*rows, s=0.3).bfloat16()
    if epilogue == "film":
        m = ((torch.arange(l, device=dev) < 30).float()[:, None]
             if mask else None)
        kw["film"] = (r(b, l, 2 * d, s=0.5).bfloat16(), m,
                      r(d, s=0.5).bfloat16())
    return x, kw


def _rownorm_oracle(epilogue, x, kw, eps=1e-6):
    """The chain in fp64 from the same bf16 operands, rounded nowhere but
    where the chain must round: the norm before RoPE."""
    xd = x.double()
    if epilogue in ("rms", "rope"):
        y = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + eps)
        y = y * kw["weight"].double()
        if epilogue == "rms":
            return y
        y = y.to(torch.bfloat16).double()
        b, l, d = y.shape
        hd = 2 * kw["cos"].shape[-1]
        yr = y.reshape(b, l, d // hd, hd // 2, 2)
        c = kw["cos"].double()[None, :, None]
        s = kw["sin"].double()[None, :, None]
        ye, yo = yr[..., 0], yr[..., 1]
        return torch.stack([ye * c - yo * s, ye * s + yo * c],
                           -1).reshape(b, l, d)
    mean = xd.mean(-1, keepdim=True)
    n = (xd - mean) * torch.rsqrt((xd - mean).square().mean(-1, keepdim=True)
                                  + eps)
    if epilogue == "affine":
        return n * kw["weight"].double() + kw["bias"].double()
    h = n * (1 + kw["scale"].double()) + kw["shift"].double()
    if "film" not in kw:
        return h
    params, mask, gate = (None if t is None else t.double()
                          for t in kw["film"])
    if mask is not None:
        params = params * mask[None]
    sc, sh = params.chunk(2, -1)
    return h * (1 + sc * gate) + sh * gate


def _rownorm_close(got, want):
    """Within 2 bf16 ulps of the largest |want| (the kernel keeps fp32
    where the eager chain rounds, and sums its statistics in another
    order, so an element may sit a rounding or two away)."""
    return ((got.float() - want.float()).abs().max().item()
            <= 2 * _bf16_ulps(want))


ROWNORM_CASES = [("rms", {}), ("rope", {}), ("affine", {}),
                 ("modulate", {}), ("modulate", {"per_token": True}),
                 ("film", {}), ("film", {"per_token": True}),
                 ("film", {"mask": False})]


@pytest.mark.parametrize("d", [1536, 5120])
@pytest.mark.parametrize("epilogue,opts", ROWNORM_CASES,
                         ids=[f"{e}{'-' + '-'.join(o) if o else ''}"
                              for e, o in ROWNORM_CASES])
def test_rownorm_kernel_matches_the_eager_chain(dev, d, epilogue, opts):
    """K5 at the 1.3B's and the 14B's widths over 37 tokens a sample (not a
    multiple of anything the kernel tiles by), RoPE with padding rows past
    f*h*w, FiLM with mask rows at zero, without a mask and without FiLM
    (the ViSM InP DiT): within 2 bf16 ulps of the eager chain, and no
    farther from the fp64 oracle than the eager chain in the 2-norm (1%
    for the order of the sums: where both round at the same points, they
    sit equally far)."""
    x, kw = _rownorm_inputs(dev, epilogue, d, **opts)
    got = rownorm_cuda(epilogue, x, 1e-6, **kw)
    want = rownorm_plain(epilogue, x, 1e-6, **kw)
    oracle = _rownorm_oracle(epilogue, x, kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert _rownorm_close(got, want)
    assert ((got.double() - oracle).norm()
            <= 1.01 * (want.double() - oracle).norm())
    if epilogue == "rope":
        # tokens past f*h*w (32) are the norm alone
        normed = rownorm_plain("rms", x, 1e-6, weight=kw["weight"])
        assert _rownorm_close(got[:, 32:], normed[:, 32:])


@pytest.mark.parametrize("fault", ["last_chunk", "stats_over_d_minus_8"])
@pytest.mark.parametrize("epilogue", ["rms", "affine", "film"])
def test_rownorm_comparison_rejects_planted_faults(dev, fault, epilogue):
    """What a faulty kernel would give, made through the inputs: the row's
    last 16-byte chunk left unwritten (the input there), or the statistics
    taken over D - 8 (the kernel run on the first D - 8 channels, the rest
    correct); the comparison above must reject both. The last chunk holds
    half the row's energy here (x 16 times larger there): with the same
    spread in every channel, statistics over D - 8 estimate the same
    moments and move the result by less than a bf16 rounding."""
    d = 1536
    x, kw = _rownorm_inputs(dev, epilogue, d)
    x[..., -8:] *= 16
    want = rownorm_plain(epilogue, x, 1e-6, **kw)
    got = rownorm_cuda(epilogue, x, 1e-6, **kw)
    assert _rownorm_close(got, want)
    if fault == "last_chunk":
        bad = got.clone()
        bad[..., -8:] = x[..., -8:]
    else:
        cut = {k: (v[:d - 8] if k in ("weight", "bias") else
                   v[..., :d - 8].contiguous() if k in ("shift", "scale")
                   else v) for k, v in kw.items()}
        if "film" in kw:
            params, mask, gate = kw["film"]
            sc, sh = params.chunk(2, -1)
            cut["film"] = (torch.cat([sc[..., :d - 8], sh[..., :d - 8]],
                                     -1).contiguous(), mask, gate[:d - 8])
        part = rownorm_cuda(epilogue, x[..., :d - 8].contiguous(), 1e-6,
                            **cut)
        bad = torch.cat([part, want[..., d - 8:]], -1)
    torch.cuda.synchronize()
    assert not _rownorm_close(bad, want)


def test_rownorm_counts_launches_and_skips_a_gradient(dev):
    """One launch a call, counted under its epilogue; a call that carries a
    gradient goes through ``RowNorm``: the same forward launch (the same
    bits), and one launch of the backward, counted under its epilogue."""
    x, kw = _rownorm_inputs(dev, "rope", 256)
    before, bwd = rownorm_cuda.launches, rownorm_bwd_cuda.launches
    by = dict(rownorm_cuda.epilogues)
    by_bwd = dict(rownorm_bwd_cuda.epilogues)
    out = rms_norm(x, kw["weight"], 1e-6, torch.bfloat16, kw["cos"],
                   kw["sin"])
    assert rownorm_cuda.launches == before + 1
    assert rownorm_cuda.epilogues["rope"] == by.get("rope", 0) + 1
    w = kw["weight"].clone().requires_grad_(True)
    taped = rms_norm(x, w, 1e-6, torch.bfloat16, kw["cos"], kw["sin"])
    assert rownorm_cuda.launches == before + 2
    assert taped.grad_fn is not None
    torch.cuda.synchronize()
    assert torch.equal(out, taped.detach())
    taped.float().sum().backward()
    assert rownorm_bwd_cuda.launches == bwd + 1
    assert rownorm_bwd_cuda.epilogues["rope"] == by_bwd.get("rope", 0) + 1
    assert w.grad is not None and w.grad.dtype == torch.float32
    with torch.no_grad():
        rms_norm(x, w, 1e-6, torch.bfloat16)
    assert rownorm_cuda.launches == before + 3
    assert rownorm_bwd_cuda.launches == bwd + 1


def test_rownorm_dispatch_takes_a_strided_x(dev):
    """A sequence-parallel rank's tokens are a strided cut of the batch
    ([B, L, D] narrowed on L): the dispatchers launch K5 on a contiguous
    copy and give the same bits as on the contiguous tensor."""
    from more4d_tpu_torch.kernels.rownorm import modulate

    x, kw = _rownorm_inputs(dev, "film", 256, l=74)
    cut = x.narrow(1, 0, 37)
    assert not cut.is_contiguous()
    params, mask, gate = kw["film"]
    film = (params[:, :37].contiguous(), mask[:37], gate)
    before = rownorm_cuda.launches
    got = modulate(cut, 1e-6, kw["shift"], kw["scale"], film)
    want = modulate(cut.contiguous(), 1e-6, kw["shift"], kw["scale"], film)
    torch.cuda.synchronize()
    assert rownorm_cuda.launches == before + 2
    assert torch.equal(got, want)
    w = kw["shift"].new_ones(256, dtype=torch.float32)
    assert torch.equal(rms_norm(cut, w, 1e-6, torch.bfloat16),
                       rms_norm(cut.contiguous(), w, 1e-6, torch.bfloat16))


def test_rownorm_raises_on_what_it_cannot_take(dev):
    x, kw = _rownorm_inputs(dev, "rms", 256)
    for bad in (x.float(), x[..., :252], x.transpose(0, 1),
                torch.zeros(2, 3, 8200, dtype=torch.bfloat16, device=dev),
                torch.zeros(2, 3, 20000, dtype=torch.bfloat16, device=dev)):
        with pytest.raises(ValueError):
            rownorm_cuda("rms", bad, 1e-6, weight=torch.ones(
                bad.shape[-1], device=dev))
    x, kw = _rownorm_inputs(dev, "rope", 256, hd=128)
    with pytest.raises(ValueError):       # head dim 12, not a multiple of 8
        rownorm_cuda("rope", x, 1e-6, weight=kw["weight"],
                     cos=kw["cos"][:, :6].contiguous(),
                     sin=kw["sin"][:, :6].contiguous())


def test_dit_takes_rownorm_without_a_gradient_only(dev):
    """A 2-block 4D-STraG DiT (i2v, bf16): 8 K5 launches a block a forward
    without a gradient (2 film, 1 affine, 2 rope, 3 rms: the cross q and
    the text and CLIP k), and in a training forward and backward the same
    8 forward launches through ``RowNorm`` and 8 of the backward. Each is
    held against the same DiT with the eager chains (``_route`` PLAIN):
    the no-gradient output within 2e-2 of the eager forward's (2-norm),
    and the training output and every parameter gradient within 2e-2 of
    the eager forward's and backward's."""
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.models import WanDiT

    cfg = dit_tiny(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                   in_dim=16, out_dim=4, text_dim=32, clip_dim=32,
                   text_len=16, motion_guidance=True, model_type="i2v")
    g = torch.Generator(dev).manual_seed(0)
    with torch.device(dev):
        dit = WanDiT(cfg)
    dit.init_weights(torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        for name, p in dit.named_parameters():
            if name.startswith("head.head") or name.endswith(".gate") or \
                    ".spatial_guide." in name:
                p.normal_(0.0, 0.02, generator=g)
    args = (torch.randn(1, 3, 16, 16, 4, device=dev, generator=g),
            torch.tensor([400.0], device=dev),
            torch.randn(1, 16, 32, device=dev, generator=g))
    kw = dict(y=torch.randn(1, 3, 16, 16, 12, device=dev, generator=g),
              clip_fea=torch.randn(1, cfg.clip_tokens, 32, device=dev,
                                   generator=g),
              mpm_features=torch.randn(1, 196, cfg.motion_feature_dim,
                                       device=dev, generator=g))

    def train():
        dit.zero_grad(set_to_none=True)
        out = dit(*args, **kw)
        out.float().square().mean().backward()
        return out.detach(), [p.grad for p in dit.parameters()]

    def rel(got, want):
        num = sum((a.float() - w.float()).square().sum()
                  for a, w in zip(got, want))
        den = sum(w.float().square().sum() for w in want)
        return (num / den).sqrt().item()

    before = dict(rownorm_cuda.epilogues)
    with torch.no_grad():
        fast = dit(*args, **kw)
    counts = {e: n - before.get(e, 0)
              for e, n in rownorm_cuda.epilogues.items()}
    assert {e: n for e, n in counts.items() if n} == dict(
        film=4, affine=2, rope=4, rms=6)
    n0, b0 = rownorm_cuda.launches, rownorm_bwd_cuda.launches
    out, grads = train()
    torch.cuda.synchronize()
    assert rownorm_cuda.launches == n0 + 16
    assert rownorm_bwd_cuda.launches == b0 + 16
    assert all(t is not None for t in grads)
    route = rownorm._route
    rownorm._route = lambda *a: rownorm.PLAIN
    try:
        n0 = rownorm_cuda.launches
        with torch.no_grad():
            eager = dit(*args, **kw)
        eager_out, eager_grads = train()
        torch.cuda.synchronize()
        assert rownorm_cuda.launches == n0
    finally:
        rownorm._route = route
    errs = dict(forward=rel([fast], [eager]),
                train_forward=rel([out], [eager_out]),
                grads=rel(grads, eager_grads))
    assert all(e < 2e-2 for e in errs.values()), errs


# ------------------------------------------------------------ K5 backward

def _rownorm_taped(epilogue, x, kw, frozen=()):
    """(x, kw) copies whose float operands record a gradient (all but the
    names in ``frozen``); the mask and the RoPE rows never do."""
    def leaf(t, name):
        t = t.detach().clone()
        return t.requires_grad_(name not in frozen)
    out = {}
    for k, v in kw.items():
        if k == "film":
            params, mask, gate = v
            out[k] = (leaf(params, "params"), mask, leaf(gate, "gate"))
        elif k in ("cos", "sin"):
            out[k] = v
        else:
            out[k] = leaf(v, k)
    return leaf(x, "x"), out


def _rownorm_leaves(x, kw):
    """{name: leaf} of a call's operands that take a gradient."""
    leaves = {"x": x}
    for k, v in kw.items():
        if k == "film":
            leaves["params"], leaves["gate"] = v[0], v[2]
        elif k not in ("cos", "sin"):
            leaves[k] = v
    return leaves


def _rownorm_function_grads(epilogue, x, kw, dy, frozen=()):
    """The gradients through ``RowNorm`` (K5 and its backward): {name: grad
    or None}."""
    xt, kt = _rownorm_taped(epilogue, x, kw, frozen)
    params, mask, gate = kt.get("film", (None, None, None))
    out = rownorm.RowNorm.apply(epilogue, xt, 1e-6, kt.get("weight"),
                                kt.get("bias"), kt.get("shift"),
                                kt.get("scale"), params, mask, gate,
                                kt.get("cos"), kt.get("sin"))
    out.backward(dy)
    return {k: t.grad for k, t in _rownorm_leaves(xt, kt).items()}


def _rownorm_eager_grads(epilogue, x, kw, dy):
    """Autograd of the eager chain (the plain version): {name: grad}."""
    xt, kt = _rownorm_taped(epilogue, x, kw)
    rownorm_plain(epilogue, xt, 1e-6, **kt).backward(dy)
    return {k: t.grad for k, t in _rownorm_leaves(xt, kt).items()}


def _rownorm_grad_oracle(epilogue, x, kw, dy):
    """The backward's mathematics (its plain version) in fp64 from the same
    operands and fp64 statistics."""
    def wide(t):
        return None if t is None else t.double()
    dk = {k: (tuple(map(wide, v)) if k == "film" else wide(v))
          for k, v in kw.items()}
    xd = x.double()
    return rownorm.rownorm_backward_plain(
        epilogue, xd, dy.double(), rownorm.row_stats(epilogue, xd, 1e-6),
        **dk)


def _rownorm_grads_ok(got, eager, oracle):
    """Each gradient within 1% (2-norm) of the eager chain's, and no
    farther from the fp64 oracle than the eager chain's in the 2-norm (1%
    for the order of the sums, and 1e-5 of the oracle's norm for fp32
    gradients, where both sides sit at fp32 rounding): {name: (error,
    eager's error)} and whether all hold."""
    errs, ok = {}, True
    for name, o in oracle.items():
        k, e = got[name].double(), eager[name].double()
        ke, ee = (k - o).norm().item(), (e - o).norm().item()
        errs[name] = (ke, ee)
        floor = 1e-5 * o.norm().item() if got[name].dtype == \
            torch.float32 else 0.0
        ok &= (k - e).norm().item() <= 1e-2 * e.norm().item() + floor
        ok &= ke <= 1.01 * ee + floor
    return errs, ok


ROWNORM_BWD_CASES = ROWNORM_CASES + [("rms", {"bf16": True}),
                                     ("affine", {"bf16": True})]


def _rownorm_bwd_case(dev, epilogue, d, opts):
    opts = dict(opts)
    bf16 = opts.pop("bf16", False)
    x, kw = _rownorm_inputs(dev, epilogue, d, **opts)
    if bf16:                    # the norm's weight and bias stored in bf16
        kw = {k: (v.bfloat16() if k in ("weight", "bias") else v)
              for k, v in kw.items()}
    g = torch.Generator(dev).manual_seed(11)
    dy = torch.randn(x.shape, device=dev, generator=g).bfloat16()
    return x, kw, dy


@pytest.mark.parametrize("d", [1536, 5120])
@pytest.mark.parametrize("epilogue,opts", ROWNORM_BWD_CASES,
                         ids=[f"{e}{'-' + '-'.join(o) if o else ''}"
                              for e, o in ROWNORM_BWD_CASES])
def test_rownorm_backward_matches_the_eager_chain(dev, d, epilogue, opts):
    """K5's backward through ``RowNorm`` at the 1.3B's and the 14B's widths
    over 37 tokens a sample, every epilogue, per-sample and per-token adaLN
    rows, FiLM with and without a mask, fp32 and bf16 norm weights: each
    gradient within 1% of autograd of the eager chain and no farther from
    the fp64 oracle than it; the same bits in a second run; and in each
    operand's dtype and shape."""
    x, kw, dy = _rownorm_bwd_case(dev, epilogue, d, opts)
    got = _rownorm_function_grads(epilogue, x, kw, dy)
    again = _rownorm_function_grads(epilogue, x, kw, dy)
    eager = _rownorm_eager_grads(epilogue, x, kw, dy)
    oracle = _rownorm_grad_oracle(epilogue, x, kw, dy)
    torch.cuda.synchronize()
    assert set(got) == set(oracle)
    for name, t in got.items():
        assert t.dtype == eager[name].dtype and t.shape == eager[name].shape
        assert torch.equal(t, again[name]), name
    errs, ok = _rownorm_grads_ok(got, eager, oracle)
    assert ok, errs


@pytest.mark.parametrize("epilogue", ["rope", "affine", "film"])
def test_rownorm_backward_takes_only_the_gradients_asked_for(dev, epilogue):
    """With the norm's weights frozen (ViSM LoRA training) the backward
    gives x its gradient alone (and the FiLM projection and gate theirs),
    the same bits as when every gradient is asked for."""
    x, kw, dy = _rownorm_bwd_case(dev, epilogue, 1536, {})
    frozen = ("weight", "bias", "shift", "scale")
    some = _rownorm_function_grads(epilogue, x, kw, dy, frozen=frozen)
    every = _rownorm_function_grads(epilogue, x, kw, dy)
    torch.cuda.synchronize()
    for name, t in some.items():
        if name in frozen:
            assert t is None, name
        else:
            assert torch.equal(t, every[name]), name


@pytest.mark.parametrize("fault", ["last_chunk", "strip_dropped"])
@pytest.mark.parametrize("epilogue", ["rms", "affine", "film"])
def test_rownorm_backward_comparison_rejects_planted_faults(dev, fault,
                                                            epilogue):
    """What a faulty backward would give: the row's last 16-byte chunk of
    dx left unwritten (zeros there), or a column sum added over every
    strip of rows but the last (its rows' share taken out); the comparison
    above must reject both. The last chunk holds half the row's energy
    here (x and dy 16 times larger there)."""
    x, kw, dy = _rownorm_bwd_case(dev, epilogue, 1536, {})
    x[..., -8:] *= 16
    dy[..., -8:] *= 16
    got = _rownorm_function_grads(epilogue, x, kw, dy)
    eager = _rownorm_eager_grads(epilogue, x, kw, dy)
    oracle = _rownorm_grad_oracle(epilogue, x, kw, dy)
    assert _rownorm_grads_ok(got, eager, oracle)[1]
    bad = dict(got)
    if fault == "last_chunk":
        bad["x"] = got["x"].clone()
        bad["x"][..., -8:] = 0
    else:
        rows = x.numel() // x.shape[-1]
        groups = x.shape[0] if epilogue == "film" else 1
        group_rows = rows // groups
        strips = rownorm._strips(rownorm.EPILOGUES.index(epilogue),
                                 x.shape[-1], False, group_rows, groups,
                                 x.get_device())
        per = -(-group_rows // strips)
        # the last strip's share: its rows (the last of the last group)
        # alone carrying a gradient
        only = torch.zeros_like(dy)
        last = group_rows - (strips - 1) * per
        d = x.shape[-1]
        only.view(-1, d)[-last:] = dy.view(-1, d)[-last:]
        share = rownorm.rownorm_backward_plain(
            epilogue, x, only, rownorm.row_stats(epilogue, x, 1e-6), **kw)
        # FiLM: the last sample's shift (the last rows are masked, and
        # give the gate nothing)
        name = "weight" if epilogue != "film" else "shift"
        bad[name] = got[name] - share[name]
    torch.cuda.synchronize()
    assert not _rownorm_grads_ok(bad, eager, oracle)[1]


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_rownorm_takes_a_blocks_norms_under_remat(dev, policy):
    """One full-width 4D-STraG block (1.3B, i2v, motion guidance, bf16,
    fp32 parameters) forward and backward, rematerialised under
    ``policy``: every norm site through ``RowNorm``, K5 launched 16 times (the
    forward and the backward's run, 8 each) and its backward 8 times; the
    parameter gradients and x's within 2% (2-norm) of the eager block's."""
    from more4d_tpu_torch.config import dit_1_3b
    from more4d_tpu_torch.models.wan_dit import WanBlock
    from more4d_tpu_torch.nn.remat import Remat
    from more4d_tpu_torch.nn.rope import RopeTables, rope_angles_3d

    cfg = dit_1_3b(motion_guidance=True)
    g = torch.Generator(dev).manual_seed(7)
    with torch.device(dev):
        blk = WanBlock(cfg)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1,
                      generator=g)
        for m in blk.modules():
            if hasattr(m, "eps") and hasattr(m, "weight"):
                m.weight.add_(1.0)
    b, l, d = 1, 37, cfg.dim
    cos, sin = rope_angles_3d(RopeTables.create(cfg.head_dim), (1, 4, 8),
                              seq_len=l, device=dev)
    x = torch.randn(b, l, d, device=dev, generator=g).bfloat16()
    args = (torch.randn(b, 6, d, device=dev, generator=g) * 0.1,
            torch.randn(b, cfg.text_len + cfg.clip_tokens, d, device=dev,
                        generator=g).bfloat16(),
            cos, sin, torch.full((b,), 32, dtype=torch.int32, device=dev),
            torch.randn(b, l, cfg.motion_feature_dim, device=dev,
                        generator=g).bfloat16(),
            (torch.arange(l, device=dev) < 30).float()[:, None])

    def grads():
        blk.zero_grad()
        xt = x.clone().requires_grad_(True)
        out = Remat(policy, dev).run(blk, xt, *args)
        out.float().square().mean().backward()
        return [xt.grad] + [p.grad for p in blk.parameters()]

    n0, b0 = rownorm_cuda.launches, rownorm_bwd_cuda.launches
    by = dict(rownorm_bwd_cuda.epilogues)
    got = grads()
    torch.cuda.synchronize()
    assert rownorm_cuda.launches - n0 == 16
    assert rownorm_bwd_cuda.launches - b0 == 8
    assert {e: n - by.get(e, 0) for e, n in rownorm_bwd_cuda.epilogues.items()
            if n - by.get(e, 0)} == dict(film=2, affine=1, rope=2, rms=3)
    route = rownorm._route
    rownorm._route = lambda *a: rownorm.PLAIN
    try:
        want = grads()
    finally:
        rownorm._route = route
    num = sum((a.float() - w.float()).square().sum()
              for a, w in zip(got, want))
    den = sum(w.float().square().sum() for w in want)
    assert (num / den).sqrt().item() < 2e-2


# ------------------------------------------------------------------ K6

FP8 = torch.float8_e4m3fn
# the 14B's fp8 matrices: q, k, v, o and k_img, v_img; fc1; fc2; FiLM
WIDEN_SHAPES = [(5120, 5120), (13824, 5120), (5120, 13824), (10240, 768)]


def _codes(n, dev, seed=0, first=256):
    """n e4m3 codes on the card: the ``first`` codes 0, 1, ... in order
    (all 256 where n allows), the rest random."""
    g = torch.Generator(dev).manual_seed(seed)
    c = torch.randint(0, 256, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    k = min(n, first)
    c[:k] = torch.arange(k, device=dev, dtype=torch.int32) % 256
    return c.to(torch.uint8)


def _same_widening(got, want):
    """K6's output against the plain version's: the same bits where the
    plain one is finite, NaN where it is NaN."""
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    assert got.dtype == want.dtype and got.dtype in bits
    assert got.shape == want.shape and got.is_contiguous()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    as_int = bits[got.dtype]
    assert torch.equal(got.view(as_int)[~nan], want.view(as_int)[~nan])


OUT = [torch.bfloat16, torch.float32]
OUT_IDS = ["bf16", "fp32"]


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
@pytest.mark.parametrize("shape", WIDEN_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDEN_SHAPES])
def test_widen_kernel_matches_plain_at_the_14b_shapes(dev, shape, scaled):
    p = _codes(shape[0] * shape[1], dev).view(FP8).view(shape)
    scale = torch.tensor(0.0123, device=dev) if scaled else None
    _same_widening(widen_fp8_cuda(p, torch.bfloat16, scale),
                   widen_fp8_plain(p, torch.bfloat16, scale))


@pytest.mark.parametrize("scale", [None, 1.0, 0.0123, 1 / 448, 7.25, 1e-12,
                                   1e-36])
def test_widen_kernel_gives_every_code_the_plain_bits(dev, scale):
    """All 256 codes, 64 times over; a scale of 1e-36 puts the fp32
    products among the subnormals (neither side flushes them). The NaN
    codes' bits are the plain version's too (both round through the same
    instruction)."""
    p = _codes(256 * 64, dev, first=256 * 64).view(FP8)
    s = None if scale is None else torch.tensor(scale, device=dev)
    got = widen_fp8_cuda(p, torch.bfloat16, s)
    want = widen_fp8_plain(p, torch.bfloat16, s)
    _same_widening(got, want)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("scale", [None, 1.0, 0.0123, 1 / 448, 7.25, 1e-12,
                                   1e-36])
def test_widen_kernel_to_fp32_gives_every_code_the_plain_bits(dev, scale):
    """The fp32 output (the time embedding's), all 256 codes 64 times over,
    NaN bits included: unscaled, PyTorch's e4m3 -> float (0x7ff00000 and
    its sign for the NaN codes); scaled, the product rounded to bf16 and
    widened, as the plain version does."""
    p = _codes(256 * 64, dev, first=256 * 64).view(FP8)
    s = None if scale is None else torch.tensor(scale, device=dev)
    got = widen_fp8_cuda(p, torch.float32, s)
    want = widen_fp8_plain(p, torch.float32, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if s is None:
        nan = got.view(torch.int32)[[0x7F, 0xFF]].tolist()
        assert nan == [0x7FF00000, -0x100000]


@pytest.mark.parametrize("offset", [0, 1, 7, 8, 13, 16])
@pytest.mark.parametrize("n", [1, 7, 15, 16, 17, 33, 255, 4096 + 3,
                               1000003])
def test_widen_kernel_takes_any_length_and_offset(dev, n, offset):
    """Views at ``offset`` bytes into a flat buffer, of lengths that are
    not multiples of 16: the scalar head and tail, and the whole tensor
    element by element where the output cannot align with the input."""
    flat = _codes(offset + n + 5, dev, seed=n + offset)
    p = flat[offset:offset + n].view(FP8)
    for scale in (None, torch.tensor(0.37, device=dev)):
        for out in OUT:
            _same_widening(widen_fp8_cuda(p, out, scale),
                           widen_fp8_plain(p, out, scale))
    assert torch.equal(flat[:offset], _codes(offset + n + 5, dev,
                                             seed=n + offset)[:offset])


def test_widen_kernel_on_the_streamed_blocks_layout(dev):
    """fp8 views of one flat device buffer laid out as the streamed blocks'
    (``parallel/offload.py``: every tensor at a 256-byte offset, bf16
    vectors between the matrices)."""
    from more4d_tpu_torch.parallel.offload import _layout, _views

    specs = [("a.bias", (37,), torch.bfloat16), ("a.weight", (1000, 768), FP8),
             ("b.bias", (13,), torch.bfloat16), ("b.weight", (77, 129), FP8),
             ("c.weight", (5120, 1000), FP8)]
    offsets, nbytes = _layout(specs)
    flat = _codes(nbytes, dev, seed=3)
    views = _views(flat, specs, offsets)
    for name, v in views.items():
        if v.dtype != FP8:
            continue
        assert v.data_ptr() % 256 == 0 and v.is_contiguous()
        for out in OUT:
            _same_widening(widen_fp8_cuda(v, out), widen_fp8_plain(v, out))


def test_widen_counts_launches_and_bytes(dev):
    p = _codes(5000, dev).view(FP8).view(50, 100)
    n0, b0 = widen_fp8_cuda.launches, widen_fp8_cuda.bytes
    widen_fp8_cuda(p)
    assert (widen_fp8_cuda.launches - n0, widen_fp8_cuda.bytes - b0) == (
        1, 5000)
    widen_fp8_cuda(p, torch.bfloat16, torch.tensor(2.0, device=dev))
    assert (widen_fp8_cuda.launches - n0, widen_fp8_cuda.bytes - b0) == (
        2, 10000)
    assert widen_fp8_cuda(p, torch.float32).dtype == torch.float32
    assert (widen_fp8_cuda.launches - n0, widen_fp8_cuda.bytes - b0) == (
        3, 15000)
    assert widen_fp8_cuda(p[:0]).shape == (0, 100)
    assert widen_fp8_cuda.launches - n0 == 3
    with pytest.raises(ValueError):
        widen_fp8_cuda(p, torch.float16)
    with pytest.raises(ValueError):
        widen_fp8_cuda(p.t())
    with pytest.raises(ValueError):
        widen_fp8_cuda(p.clone().requires_grad_(True))
    with pytest.raises(ValueError):
        widen_fp8_cuda(p.cpu())
    with pytest.raises(ValueError):
        widen_fp8_cuda(p, torch.bfloat16, torch.tensor(2.0))


def test_compute_param_routes_every_fp8_tensor_on_the_card_to_k6(dev):
    """An fp8 weight on the card widens by K6 to bf16 and to fp32, scaled
    or not; a bf16 bias never reaches it; what K6 cannot take (a strided
    weight, a scale on the host) raises instead of taking the plain
    cast."""
    from more4d_tpu_torch.nn.layers import Linear, compute_param

    lin = Linear(96, 48, torch.bfloat16).to(dev)
    lin.weight = torch.nn.Parameter(
        _codes(48 * 96, dev).view(FP8).view(48, 96), requires_grad=False)
    n0 = widen_fp8_cuda.launches
    for out in OUT:
        _same_widening(compute_param(lin, "weight", out),
                       widen_fp8_plain(lin.weight, out))
    assert widen_fp8_cuda.launches - n0 == 2
    assert compute_param(lin, "bias", torch.bfloat16).dtype == torch.bfloat16
    assert widen_fp8_cuda.launches - n0 == 2
    lin.register_buffer("weight_scale", torch.tensor(0.5, device=dev))
    for out in OUT:
        _same_widening(compute_param(lin, "weight", out),
                       widen_fp8_plain(lin.weight, out, lin.weight_scale))
    assert widen_fp8_cuda.launches - n0 == 4
    lin.weight_scale = torch.tensor(0.5)
    with pytest.raises(ValueError, match="scale"):
        compute_param(lin, "weight", torch.bfloat16)
    del lin.weight_scale
    lin.weight = torch.nn.Parameter(lin.weight.t(), requires_grad=False)
    with pytest.raises(ValueError, match="contiguous"):
        compute_param(lin, "weight", torch.bfloat16)
    assert widen_fp8_cuda.launches - n0 == 4


def test_fp8_dit_on_the_card_widens_by_k6_with_the_plain_bits(dev):
    """A tiny 4D-STraG DiT stored in fp8 (scaled): one forward launches
    K6 once for each fp8 tensor, the time embedding's (widened to fp32)
    included, and its output is the one the plain widening gives, bit for
    bit."""
    from more4d_tpu_torch.config import dit_tiny
    from more4d_tpu_torch.models.wan_dit import WanDiT
    from more4d_tpu_torch.nn import layers
    from more4d_tpu_torch.utils.quantize import quantize_params_fp8

    cfg = dit_tiny(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                   motion_guidance=True, model_type="i2v", text_len=24,
                   clip_tokens=9)
    g = torch.Generator(dev).manual_seed(5)
    with torch.device(dev):
        model = WanDiT(cfg).to(torch.bfloat16).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=g)
    quantize_params_fp8(model, scaled=True)
    n_fp8 = sum(p.dtype == FP8 for p in model.parameters())
    assert model.time_projection[1].weight.dtype == FP8

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    args = (r(1, 3, 8, 8, 16), torch.full((1,), 500.0, device=dev),
            r(1, cfg.text_len, cfg.text_dim))
    kw = dict(y=r(1, 3, 8, 8, cfg.in_dim - 16),
              clip_fea=r(1, cfg.clip_tokens, cfg.clip_dim),
              mpm_features=r(1, 16, cfg.motion_feature_dim))
    n0 = widen_fp8_cuda.launches
    with torch.no_grad():
        got = model(*args, **kw)
    assert widen_fp8_cuda.launches - n0 == n_fp8
    dispatch = layers.widen_fp8
    layers.widen_fp8 = widen_fp8_plain
    try:
        with torch.no_grad():
            want = model(*args, **kw)
    finally:
        layers.widen_fp8 = dispatch
    assert widen_fp8_cuda.launches - n0 == n_fp8
    assert torch.equal(got, want)
