"""The port's fp8 weight storage (``utils/quantize.py``) against the JAX
package's ``quantize_params_fp8`` / ``dequantize_params`` on the CPU, at
tiny DiT widths.

- The cast to float8_e4m3fn: every finite bf16 value up to 464 (normals,
  e4m3 subnormals below 2^-6, ties, +-448, 0 and -0) and 4e6 fp32 values
  give JAX's bits exactly; above 464 JAX gives NaN where torch saturates
  to 448 (the reference's torch code saturates too).
- The set of quantized DiT tensors and every tensor's bits equal JAX's
  (tolerance 0), for the 4D-STraG DiT (in_dim 64, with the ref and camera
  convs) and the InP DiT (in_dim 36); the rule reads the JAX parameter
  path, where the port's ``*_embedding`` names are JAX's ``*_fc*``, and
  the rank of JAX's scanned block leaves.
- The scaled round trip equals ``dequantize_params`` bit for bit.
- An fp8 DiT's forward matches JAX's, fp32 compute: atol 2e-4 (the
  tolerance of ``test_torch_wan_dit.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.models.wan_dit import WanDiT as JaxWanDiT
from more4d_tpu.utils.quantize import cast_float_leaves as jax_cast
from more4d_tpu.utils.quantize import dequantize_params as jax_dequantize
from more4d_tpu.utils.quantize import quantize_params_fp8 as jax_quantize
from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.convert import dit_state_dict
from more4d_tpu_torch.models.wan_dit import WanDiT
from more4d_tpu_torch.nn.layers import from_state_dict
from more4d_tpu_torch.utils.quantize import (FP8, cast_float_leaves,
                                             dequantize_params, jax_param,
                                             quantize_params_fp8)

VARIANTS = {
    "motion_64": dict(model_type="i2v", in_dim=64, motion_guidance=True,
                      ref_conv=True, control_adapter=True),
    "inp_36": dict(model_type="i2v", in_dim=36),
}
B, T, H, W = 1, 2, 8, 8


def _inputs(cfg, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, H, W, 16).astype(np.float32)
    kw = dict(y=rs.randn(B, T, H, W, cfg.in_dim - 16).astype(np.float32),
              clip_fea=rs.randn(B, cfg.clip_tokens, cfg.clip_dim).astype(
                  np.float32))
    if cfg.motion_guidance:
        kw["mpm_features"] = rs.randn(B, 196, cfg.motion_feature_dim
                                      ).astype(np.float32)
    if cfg.ref_conv:
        kw["full_ref"] = rs.randn(B, H, W, cfg.ref_conv_dim).astype(
            np.float32)
    if cfg.control_adapter:
        kw["y_camera"] = rs.randn(B, T, H, W, cfg.control_adapter_dim
                                  ).astype(np.float32)
    ctx = rs.randn(B, cfg.text_len - 3, cfg.text_dim).astype(np.float32)
    return x, np.array([700.0], np.float32), ctx, kw


def _pair(variant, seed=0):
    """(JAX cfg, port cfg, JAX module, JAX fp32 params, inputs)."""
    jcfg = jax_dit_tiny(dtype=jnp.float32, **VARIANTS[variant])
    tcfg = dit_tiny(dtype=torch.float32, **VARIANTS[variant])
    x, t, ctx, kw = _inputs(jcfg)
    jdit = JaxWanDiT(jcfg)
    shapes = jax.eval_shape(jdit.init, jax.random.PRNGKey(0), x, t, ctx, **kw)
    leaves, td = jax.tree_util.tree_flatten(shapes)
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, 0.05, l.shape), np.float32)
             for l in leaves])
    return jcfg, tcfg, jdit, params, (x, t, ctx, kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as float32 bit patterns (exact for fp8 and bf16,
    signed zeros kept)."""
    return t.float().contiguous().view(torch.int32).numpy()


def _port_names(tree, tcfg, pick):
    """The port's names of the JAX leaves ``pick`` selects (the tree goes
    through the converter as markers, so the renames and layouts are the
    converter's)."""
    marks = jax.tree_util.tree_map(
        lambda a: np.full(np.shape(a), float(pick(a)), np.float32), tree)
    return {k for k, v in dit_state_dict(marks, tcfg).items()
            if bool(v.flatten()[0])}


@pytest.mark.parametrize("source", ["bf16_all", "fp32_random"])
def test_fp8_cast_matches_jax(source):
    if source == "bf16_all":
        x = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(
            ml_dtypes.bfloat16)
        x = x[np.isfinite(x.astype(np.float32))]
        tx = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    else:
        rs = np.random.RandomState(0)
        x = np.concatenate([rs.randn(10 ** 6).astype(np.float32) * s
                            for s in (1e-3, 0.02, 1.0, 100.0)])
        tx = torch.from_numpy(x)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = tx.to(FP8).view(torch.uint8).numpy()
    f32 = x.astype(np.float32)
    inside = np.abs(f32) <= 464
    np.testing.assert_array_equal(got[inside], want[inside])
    if source == "bf16_all":
        special = np.array([0.0, -0.0, 448.0, -448.0, 2.0 ** -9,
                            2.0 ** -7 + 2.0 ** -10, 240.0 + 8.0],
                           np.float32)
        assert np.isin(special, f32).all()   # ties, subnormals, +-448, -0
        assert ((f32 > 0) & (f32 < 2.0 ** -6)).sum() > 100
        # above 464 JAX gives NaN, torch saturates
        above = np.abs(f32) > 464
        assert (want[above] & 0x7F == 0x7F).all()
        assert (got[above] & 0x7F == 0x7E).all()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_quantized_set_and_bytes_match_jax(variant):
    """The CLI's order on both sides: cast to bf16, then the unscaled fp8
    storage."""
    _, tcfg, _, params, _ = _pair(variant)
    want = jax_quantize(jax_cast(params, jnp.bfloat16), scaled=False)
    model = from_state_dict(lambda: WanDiT(tcfg),
                            dit_state_dict(params, tcfg), torch.bfloat16)
    quantize_params_fp8(model, scaled=False)
    sd = model.state_dict()
    fp8 = {k for k, v in sd.items() if v.dtype == FP8}
    assert fp8 == _port_names(want, tcfg,
                              lambda a: a.dtype == jnp.float8_e4m3fn)
    # JAX's names have no 'embedding' where the port's do: these are fp8
    for name in ("text_embedding.0.weight", "time_embedding.2.weight",
                 "time_projection.1.weight", "img_emb.proj.1.weight",
                 "head.head.weight", "blocks.1.cross_attn.k_img.weight"):
        assert name in fp8, name
    # JAX's blocks are one stacked leaf a rank up: biases and gates qualify
    assert "blocks.0.self_attn.q.bias" in fp8
    assert "text_embedding.0.bias" not in fp8
    assert "patch_embedding.weight" not in fp8
    assert "blocks.0.modulation" not in fp8
    assert "blocks.0.norm3.weight" not in fp8
    if variant == "motion_64":
        for name in ("control_adapter.weight", "ref_conv.weight",
                     "feature_adapter.2.weight",
                     "blocks.0.spatial_guidance_ffn.spatial_guide.1.weight"):
            assert name in fp8, name
    ref = dit_state_dict(want, tcfg)
    assert set(ref) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(_bits(v), _bits(ref[k]), err_msg=k)
    assert jax_param("text_embedding.0.weight", torch.zeros(2, 2)) == (
        "params/text_fc1/kernel", 2)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_scaled_roundtrip_equals_jax_dequantize(variant):
    _, tcfg, _, params, _ = _pair(variant, seed=1)
    q = jax_quantize(jax_cast(params, jnp.bfloat16), scaled=True)
    model = from_state_dict(lambda: WanDiT(tcfg),
                            dit_state_dict(params, tcfg), torch.bfloat16)
    quantize_params_fp8(model, scaled=True)

    def scaled(a):
        return isinstance(a, dict) and set(a) == {"fp8", "scale"}

    fp8_tree = jax.tree_util.tree_map(lambda a: a["fp8"] if scaled(a) else a,
                                      q, is_leaf=scaled)
    sd = model.state_dict()
    for k, v in dit_state_dict(fp8_tree, tcfg).items():
        np.testing.assert_array_equal(_bits(sd[k]), _bits(v), err_msg=k)
    want = dit_state_dict(jax_dequantize(q), tcfg)
    got = dequantize_params(model)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp8_forward_matches_jax(variant):
    """fp32 weights cast straight to fp8 (unscaled) on both sides; flax
    widens the fp8 kernels to fp32 inside each layer, as the port's
    layers do."""
    _, tcfg, jdit, params, (x, t, ctx, kw) = _pair(variant, seed=2)
    want = np.asarray(jdit.apply(jax_quantize(params, scaled=False), x, t,
                                 ctx, **kw))
    model = WanDiT(tcfg)
    model.load_state_dict(dit_state_dict(params, tcfg), strict=True)
    quantize_params_fp8(model, scaled=False)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx),
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    plain = np.asarray(jdit.apply(params, x, t, ctx, **kw))
    assert np.abs(got.numpy() - want).max() < 2e-4
    assert np.abs(want - plain).max() > 1e-2     # fp8 did change the output


def test_cast_float_leaves_casts_floats_only():
    sd = {"w": torch.ones(2, 2), "i": torch.ones(2, dtype=torch.int32)}
    out = cast_float_leaves(sd, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int32
    assert cast_float_leaves(sd, None) is sd
