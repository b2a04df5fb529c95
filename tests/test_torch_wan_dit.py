"""The port's WanDiT against the JAX WanDiT, with the same converted
weights, at a tiny fp32 config on the CPU (the JAX side attends through its
XLA path, the port through the flash kernel's plain version).

Tolerance: atol 2e-4 on outputs of magnitude ~1. Both sides compute in
fp32 but sum in different orders (fused qkv, einsum vs bmm, conv
algorithms), which leaves ~1e-5 differences that 2 blocks amplify a little.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.convert.dit_torch import (convert_dit_state_dict,
                                          wan_dit_key_manifest)
from more4d_tpu.models.wan_dit import WanDiT as JaxWanDiT
from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.convert import dit_state_dict
from more4d_tpu_torch.models.wan_dit import WanDiT

ATOL = 2e-4
B, T, H, W = 2, 2, 8, 8


def _randomized(params, seed):
    """Non-zero weights everywhere (the zero-init head and FiLM would hide
    most of the network), of the shapes in ``params`` (arrays or the
    ShapeDtypeStructs of ``jax.eval_shape``)."""
    leaves, td = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, 0.05, l.shape), np.float32)
             for l in leaves])


def _inputs(cfg, seed=0, **extra):
    rs = np.random.RandomState(seed)
    kw = {}
    x = rs.randn(B, T, H, W, 16).astype(np.float32)
    if cfg.in_dim > 16:
        kw["y"] = rs.randn(B, T, H, W, cfg.in_dim - 16).astype(np.float32)
    if cfg.model_type == "i2v":
        kw["clip_fea"] = rs.randn(B, cfg.clip_tokens,
                                  cfg.clip_dim).astype(np.float32)
    if cfg.motion_guidance:
        kw["mpm_features"] = rs.randn(B, 196, cfg.motion_feature_dim
                                      ).astype(np.float32)
    if cfg.ref_conv:
        kw["full_ref"] = rs.randn(B, H, W, cfg.ref_conv_dim
                                  ).astype(np.float32)
    if cfg.control_adapter:
        kw["y_camera"] = rs.randn(B, T, H, W, cfg.control_adapter_dim
                                  ).astype(np.float32)
    ctx = rs.randn(B, cfg.text_len - 3, cfg.text_dim).astype(np.float32)
    t = np.array([900.0, 250.0], np.float32)
    kw.update(extra)
    return x, t, ctx, kw


def _pair(seed=0, **over):
    jcfg = jax_dit_tiny(dtype=jnp.float32, **over)
    tcfg = dit_tiny(dtype=torch.float32, **over)
    x, t, ctx, kw = _inputs(jcfg)
    jdit = JaxWanDiT(jcfg)
    params = _randomized(jax.eval_shape(jdit.init, jax.random.PRNGKey(seed),
                                        x, t, ctx, **kw), seed)
    tdit = WanDiT(tcfg)
    tdit.load_state_dict(dit_state_dict(params, tcfg), strict=True)
    return jcfg, tcfg, jdit, params, tdit


def _compare(jdit, params, tdit, x, t, ctx, kw):
    want = np.asarray(jdit.apply(params, x, t, ctx, **kw))
    with torch.no_grad():
        got = tdit(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx),
                   **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err < ATOL, err
    return got


@pytest.mark.parametrize("variant", [
    dict(model_type="t2v", in_dim=16),
    dict(model_type="i2v", in_dim=36),
    dict(model_type="i2v", in_dim=64, motion_guidance=True),
    dict(model_type="i2v", in_dim=64, motion_guidance=True, ref_conv=True),
    dict(model_type="t2v", in_dim=16, control_adapter=True),
], ids=["t2v", "i2v_inp", "4d_mpm", "4d_ref_conv", "control_adapter"])
def test_dit_matches_jax(variant):
    jcfg, _, jdit, params, tdit = _pair(**variant)
    x, t, ctx, kw = _inputs(jcfg, seed=1)
    _compare(jdit, params, tdit, x, t, ctx, kw)


def test_dit_per_token_timesteps_match_jax():
    jcfg, _, jdit, params, tdit = _pair(model_type="i2v", in_dim=64,
                                        motion_guidance=True)
    x, _, ctx, kw = _inputs(jcfg, seed=2)
    n_tok = T * (H // 2) * (W // 2)
    t = np.random.RandomState(3).uniform(0, 1000, (B, n_tok)).astype(
        np.float32)
    _compare(jdit, params, tdit, x, t, ctx, kw)


def test_dit_without_mpm_uses_zero_fallback():
    """A 4D model run without MPM features takes the zero FiLM fallback on
    both sides."""
    jcfg, _, jdit, params, tdit = _pair(model_type="i2v", in_dim=64,
                                        motion_guidance=True)
    x, t, ctx, kw = _inputs(jcfg, seed=4)
    kw.pop("mpm_features")
    _compare(jdit, params, tdit, x, t, ctx, kw)


@pytest.mark.parametrize("variant", [
    dict(model_type="i2v", in_dim=64, motion_guidance=True, ref_conv=True),
    dict(model_type="t2v", in_dim=36),
], ids=["4d_ref_conv", "t2v"])
def test_dit_keys_are_the_reference_manifest(variant):
    """The port's parameter names are the released checkpoint keys, and the
    JAX package's torch converter reads the port's state dict back into the
    JAX params it came from."""
    jcfg, tcfg, _, params, tdit = _pair(**variant)
    req, opt = wan_dit_key_manifest(jcfg)
    want = set(req) | {k for g in opt.values() for k in g}
    sd = tdit.state_dict()
    assert set(sd) == want
    back = convert_dit_state_dict(sd, jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(back["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_b[path]))
