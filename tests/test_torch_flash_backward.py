"""Flash-attention backward (K2 dq, K3 dk/dv): the port's plain version
against the JAX Pallas backward in interpret mode, and the port's autograd
path against ``jax.grad`` through the JAX entry point, on the CPU in fp32.
The CUDA kernels are held against the plain version in
``test_torch_kernels_cuda.py``, on a card.

Tolerances: fp32, atol 2e-5 on dq, dk and dv (gradients of magnitude ~1;
both sides form the same products but sum in other orders and tile
shapes). Masked keys: exactly zero dk and dv, independent of their
contents, as ``tests/test_flash_attention.py`` holds the JAX kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.kernels.flash_attention import (_flash_backward,
                                                _flash_forward,
                                                flash_attention as
                                                jax_flash_attention)
from more4d_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_bwd_plain, flash_attention_cuda,
    flash_bwd_dkv_cuda, flash_bwd_dq_cuda)

B, HEADS, D = 2, 2, 32
ATOL = 2e-5
CASES = [(17, 9, None), (40, 24, None), (32, 48, [20, 48]),
         (64, 257, None)]


def _inputs(lq, lk, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, n, HEADS, D).astype(np.float32)
            for n in (lq, lk, lk, lq)]          # q, k, v, dO


def _swap(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


@pytest.mark.parametrize("lq,lk,lens", CASES,
                         ids=["17_9", "40_24", "kv_lens_20_48", "cross_257"])
def test_plain_backward_matches_jax_kernel(lq, lk, lens):
    """Both backwards on the same q, k, v, dO, and JAX's O and lse (stored
    [B*H, 8, Lqp] there, [B*H, Lq] in the port)."""
    q, k, v, do = _inputs(lq, lk)
    kv = None if lens is None else np.array(lens, np.int32)
    jkv = None if kv is None else jnp.asarray(kv)
    scale = D ** -0.5
    o_j, lse_j = _flash_forward(_swap(q), _swap(k), _swap(v), jkv, scale,
                                512, None, True)
    want = _flash_backward(_swap(q), _swap(k), _swap(v), jkv, o_j, lse_j,
                           _swap(do), scale, 512, None, True)
    o = torch.from_numpy(np.array(jnp.swapaxes(o_j, 1, 2)))
    lse = torch.from_numpy(np.asarray(lse_j)[:, 0, :lq].copy())
    got = flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v)),
        None if kv is None else torch.from_numpy(kv), o, lse,
        torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.swapaxes(np.asarray(w), 1, 2)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() < ATOL, name


@pytest.mark.parametrize("lq,lk,lens", CASES[2:],
                         ids=["kv_lens_20_48", "cross_257"])
def test_autograd_matches_jax_grad(lq, lk, lens):
    """torch.autograd.grad through the port's flash_attention against
    jax.grad through the JAX entry point with its Pallas backward."""
    q, k, v, do = _inputs(lq, lk, seed=1)
    kv = None if lens is None else np.array(lens, np.int32)

    def f(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_,
                                  kv_lens=None if kv is None
                                  else jnp.asarray(kv),
                                  backward="pallas", interpret=True)
        return jnp.vdot(out, jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*xs, kv_lens=None if kv is None
                          else torch.from_numpy(kv))
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(), xs)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < ATOL, name


def test_masked_keys_get_exact_zero_gradients():
    q, k, v, do = _inputs(32, 48, seed=5)
    lens = torch.tensor([20, 48], dtype=torch.int32)

    def grads(k_, v_):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k_, v_)]
        out = flash_attention(*xs, kv_lens=lens)
        return torch.autograd.grad((out * torch.from_numpy(do)).sum(), xs)

    dq, dk, dv = grads(k, v)
    assert not dk[0, 20:].any() and not dv[0, 20:].any()
    k2, v2 = k.copy(), v.copy()
    k2[0, 20:] = 77.0
    v2[0, 20:] = -11.0
    dq2, dk2, dv2 = grads(k2, v2)
    torch.testing.assert_close(dq2, dq, rtol=0, atol=0)
    torch.testing.assert_close(dk2[0, :20], dk[0, :20], rtol=0, atol=0)
    torch.testing.assert_close(dv2, dv, rtol=0, atol=0)


def test_cpu_tensors_never_reach_the_kernels():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(17, 9))
    before = (flash_attention_cuda.launches, flash_bwd_dq_cuda.launches,
              flash_bwd_dkv_cuda.launches)
    xs = [x.requires_grad_() for x in (q, k, v)]
    (flash_attention(*xs) * do).sum().backward()
    assert all(x.grad is not None for x in xs)
    assert (flash_attention_cuda.launches, flash_bwd_dq_cuda.launches,
            flash_bwd_dkv_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq_cuda(*(x.detach().bfloat16() for x in (q, k, v)), None,
                          do.bfloat16(), None, None)


def test_empty_key_set_gives_no_gradient():
    q, _, _, _ = _inputs(9, 1)
    qt = torch.from_numpy(q).requires_grad_()
    empty = torch.zeros(B, 0, HEADS, D, requires_grad=True)
    out = flash_attention(qt, empty, empty)
    assert not out.any() and not out.requires_grad


def test_no_grad_runs_the_forward_alone():
    """Under no_grad the entry point gives the forward's output and builds
    no graph: inference is unchanged."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(17, 9, seed=2))
    want = flash_attention(q, k, v)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        got = flash_attention(*xs)
    assert got.grad_fn is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with_grad = flash_attention(*xs)
    assert with_grad.grad_fn is not None
    torch.testing.assert_close(with_grad.detach(), want, rtol=0, atol=0)
