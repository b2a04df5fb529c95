"""The port's CUDA kernels against their plain PyTorch versions, on a
card. These tests skip on a host without one. The file imports neither
JAX nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Tolerances: K1 (bf16) 2 bf16 ulps of the plain version's largest |O| on
O (both round O to bf16, so an element may differ by one rounding flip;
the kernel also rounds P to bf16 against the running max of each 64-key
tile while the plain version uses the row's max), atol 1e-4 on the fp32
base-2 lse (only the order of sums differs); K2/K3 (bf16) 2 bf16 ulps of
the plain version's largest |dq|, |dk|, |dv| and a relative 2-norm of
2e-3 (both sides round the result once and P and dS once per term, at the
same points; only the order of the fp32 sums differs, so an element may
sit one rounding flip away, as for K1); masked keys get exactly zero dk
and dv; K4
(fp32) atol 1e-5 on colours and alpha in [0, 1] (the same formula; exp
and the running product round alike, sums ordered the same).
"""

import numpy as np
import pytest
import torch

from more4d_tpu_torch.geometry.projection import get_intrinsic_matrix
from more4d_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_cuda, flash_attention_bwd_plain,
    flash_attention_cuda, flash_attention_plain, flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda)
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
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            diff = (g.float() - w.float())
            assert diff.abs().max().item() <= 2 * _bf16_ulps(w), name
            assert (diff.norm() / w.float().norm()).item() <= 2e-3, name
        if kv_lens is not None:
            dk, dv = got[1], got[2]
            assert not dk[1, lens[1]:].any() and not dv[1, lens[1]:].any()


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


def test_splat_entry_point_launches_on_cuda(dev):
    pts, cols = _cloud(3000, 2, dev)
    before = splat_cuda.launches
    img, alpha = gs_render_tiled(pts, cols, torch.eye(4, device=dev),
                                 get_intrinsic_matrix(32, 48, device=dev), 32,
                                 48)
    assert splat_cuda.launches == before + 1
    assert img.shape == (32, 48, 3) and alpha.shape == (32, 48)
    assert torch.isfinite(img).all()
