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
csrc/gs_splat.cu sets out).
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
