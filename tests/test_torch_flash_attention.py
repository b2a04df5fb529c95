"""Flash-attention forward (K1): the port's plain version against the JAX
Pallas kernel in interpret mode and the JAX XLA attention, on the CPU in
fp32. The CUDA kernel itself is held against the plain version in
``test_torch_kernels_cuda.py``, on a card.

Tolerances: fp32, atol 1e-5 on O (values of magnitude ~1, softmax sums in
different orders) and 1e-4 on the base-2 lse (magnitude ~10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.kernels.flash_attention import (_flash_forward,
                                                flash_attention as
                                                jax_flash_attention,
                                                xla_attention)
from more4d_tpu_torch.kernels.flash_attention import (flash_attention,
                                                      flash_attention_cuda,
                                                      flash_attention_plain)

B, HEADS, D = 2, 2, 32


def _qkv(lq, lk, seed=0, d=D):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, lq, HEADS, d).astype(np.float32),
            rs.randn(B, lk, HEADS, d).astype(np.float32),
            rs.randn(B, lk, HEADS, d).astype(np.float32))


@pytest.mark.parametrize("lq,lk", [(17, 9), (40, 24), (64, 64), (128, 512)])
def test_plain_matches_jax_kernel(lq, lk):
    q, k, v = _qkv(lq, lk)
    want_pallas = np.asarray(jax_flash_attention(q, k, v, interpret=True))
    want_xla = np.asarray(xla_attention(q, k, v))
    got = flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.abs(got - want_pallas).max() < 1e-5
    assert np.abs(got - want_xla).max() < 1e-5


@pytest.mark.parametrize("lq,lk", [(17, 9), (40, 24)])
def test_plain_kv_lens_and_lse_match_jax_kernel(lq, lk):
    """kv_lens masks the keys at or past kv_lens[b]; the base-2 lse
    equals the Pallas kernel's (stored [B*H, 8, Lqp] there)."""
    q, k, v = _qkv(lq, lk, seed=1)
    lens = np.array([lk, max(lk // 3, 1)], np.int32)
    qt, kt, vt = (jnp.swapaxes(a, 1, 2) for a in (q, k, v))
    o_j, lse_j = _flash_forward(qt, kt, vt, jnp.asarray(lens), D ** -0.5,
                                512, None, True)
    want = np.swapaxes(np.asarray(o_j), 1, 2)
    o, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   kv_lens=torch.from_numpy(lens))
    assert np.abs(o.numpy() - want).max() < 1e-5
    assert lse.shape == (B * HEADS, lq)
    assert np.abs(lse.numpy() - np.asarray(lse_j)[:, 0, :lq]).max() < 1e-4
    # masked keys really are ignored: changing them changes nothing
    k2, v2 = k.copy(), v.copy()
    k2[1, lens[1]:] = 7.0
    v2[1, lens[1]:] = -7.0
    o2 = flash_attention(*map(torch.from_numpy, (q, k2, v2)),
                         kv_lens=torch.from_numpy(lens))
    np.testing.assert_array_equal(o2.numpy(), o.numpy())
    np.testing.assert_allclose(
        o.numpy(), np.asarray(xla_attention(q, k, v, jnp.asarray(lens))),
        atol=1e-5)


def test_empty_key_set_gives_zeros():
    q, k, v = _qkv(9, 0)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)))
    want = np.asarray(jax_flash_attention(q, k, v, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_cpu_tensor_never_reaches_the_kernel():
    q, k, v = map(torch.from_numpy, _qkv(17, 9))
    before = flash_attention_cuda.launches
    flash_attention(q, k, v)
    assert flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16())
