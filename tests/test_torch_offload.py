"""The port's streamed DiT (``parallel/offload.py``), ``time_embed_e0`` and
``dit_forward_flops`` against the JAX package on the CPU, at the tiny
widths of ``tests/test_offload.py`` (2 layers, i2v with motion guidance).

Tolerances: the port's streamed forward with ``quantize='none'`` equals its
resident forward and its pipeline loop bit for bit (the same layers on the
same tensors); host blocks equal JAX's bytes (tolerance 0); TeaCache
decisions equal; the bf16 fp8-streamed forwards of the two packages agree
to 2e-2 relative (2-norm; both round to bf16 at every layer, ~3 bf16 ulps
after 2 blocks); fp32 outputs to atol 1e-4 (the tolerance of
``test_torch_two_stage.py``'s loops); FLOP counts exactly.
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import dit_1_3b as jax_dit_1_3b
from more4d_tpu.config import dit_14b as jax_dit_14b
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.diffusion import get_scheduler as jax_get_scheduler
from more4d_tpu.models.wan_dit import WanDiT as JaxWanDiT
from more4d_tpu.parallel import offload as joff
from more4d_tpu.utils.flops import dit_forward_flops as jax_flops
from more4d_tpu_torch import config as tconfig
from more4d_tpu_torch.config import PipelineConfig, VAEConfig, dit_tiny
from more4d_tpu_torch.convert import dit_state_dict
from more4d_tpu_torch.convert.params import _dit_block
from more4d_tpu_torch.diffusion import get_scheduler
from more4d_tpu_torch.models import WanDiT, WanVAE
from more4d_tpu_torch.parallel import offload
from more4d_tpu_torch.parallel.offload import (StreamedDiT, _HostTeaCache,
                                               make_host_blocks,
                                               offload_blocks_to_host,
                                               split_block_params)
from more4d_tpu_torch.pipelines import TeaCacheConfig, WanControlPipeline
from more4d_tpu_torch.utils.flops import dit_forward_flops
from more4d_tpu_torch.utils.quantize import FP8

TINY = dict(motion_guidance=True, model_type="i2v", num_layers=2,
            text_len=24, clip_tokens=9)
B, LT, LH, LW = 1, 3, 8, 8


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().contiguous().view(torch.int32).numpy()


def _setup(dtype, seed=0):
    """(JAX module, JAX params, port WanDiT, numpy inputs) with the same
    random weights (non-zero everywhere: the zero-initialised head and FiLM
    would hide the blocks) in ``dtype``."""
    jdt = {"bf16": jnp.bfloat16, "fp32": jnp.float32}[dtype]
    tdt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    jcfg = jax_dit_tiny(dtype=jdt, param_dtype=jdt, **TINY)
    tcfg = dit_tiny(dtype=tdt, param_dtype=tdt, **TINY)
    rs = np.random.RandomState(seed)
    x = dict(x=rs.randn(B, LT, LH, LW, 16),
             t=np.full((B,), 500.0),
             ctx=rs.randn(B, jcfg.text_len, jcfg.text_dim),
             y=rs.randn(B, LT, LH, LW, 48),
             clip_fea=rs.randn(B, jcfg.clip_tokens, jcfg.clip_dim),
             mpm_features=rs.randn(B, 16, jcfg.motion_feature_dim))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    jdit = JaxWanDiT(jcfg)
    shapes = jax.eval_shape(jdit.init, jax.random.PRNGKey(0), x["x"],
                            x["t"], x["ctx"], y=x["y"],
                            clip_fea=x["clip_fea"],
                            mpm_features=x["mpm_features"])
    leaves, td = jax.tree_util.tree_flatten(shapes)
    params = jax.tree_util.tree_unflatten(
        td, [jnp.asarray(rs.normal(0, 0.05, l.shape), jdt) for l in leaves])
    model = WanDiT(tcfg)
    model.load_state_dict(dit_state_dict(params, tcfg), strict=True)
    return jdit, params, model.to(tdt).eval(), x


def _kw(x, torch_=False):
    kw = {k: x[k] for k in ("y", "clip_fea", "mpm_features")}
    return {k: torch.from_numpy(v) for k, v in kw.items()} if torch_ else kw


def _streamed(model, quantize):
    resident, blocks = split_block_params(copy.deepcopy(model))
    return StreamedDiT(resident, offload_blocks_to_host(blocks, quantize,
                                                        "cpu"), "cpu")


@pytest.fixture(scope="module")
def bf16():
    return _setup("bf16")


@pytest.fixture(scope="module")
def fp32():
    return _setup("fp32", seed=1)


def test_streamed_none_equals_resident_exactly(bf16):
    _, _, model, x = bf16
    args = [torch.from_numpy(x[k]) for k in ("x", "t", "ctx")]
    with torch.no_grad():
        want = model(*args, **_kw(x, True))
    sdit = _streamed(model, "none")
    got = sdit(*args, **_kw(x, True))
    assert torch.equal(got, want)
    assert sdit.host_blocks[0].tensors["self_attn.q.weight"].dtype == \
        torch.bfloat16
    assert len(model.blocks) == 2      # split_block_params took a copy


@pytest.mark.parametrize("quantize", ["fp8", "bf16", "none"])
def test_host_blocks_match_jax(bf16, quantize):
    """Every block tensor's storage dtype and bytes equal JAX's
    ``offload_blocks_to_host``: fp8 only for matrices, a non-eligible
    leaf bf16 whatever the model's dtype, 'none' keeping it."""
    jdit, params, model, _ = bf16
    _, stacked = joff.split_block_params(params)
    want = joff.offload_blocks_to_host(stacked, 2, quantize=quantize)
    _, blocks = split_block_params(copy.deepcopy(model))
    got = offload_blocks_to_host(blocks, quantize, "cpu")
    cfg = model.cfg
    for k in range(2):
        tree = jax.tree_util.tree_map(np.asarray, want[k])
        ref, marks = {}, {}
        _dit_block(ref, "b", tree, cfg)
        _dit_block(marks, "b", jax.tree_util.tree_map(
            lambda a: np.full(a.shape, float(a.dtype == jnp.float8_e4m3fn)),
            tree), cfg)
        host = got[k].tensors
        assert {"b." + n for n in host} == set(ref)
        for n, v in host.items():
            assert (v.dtype == FP8) == bool(marks["b." + n].flatten()[0]), n
            if quantize != "none":
                assert v.dtype in (FP8, torch.bfloat16), n
            np.testing.assert_array_equal(_bits(v), _bits(ref["b." + n]),
                                          err_msg=n)
    assert got[0].tensors["self_attn.q.weight"].dtype == (
        FP8 if quantize == "fp8" else torch.bfloat16)
    assert got[0].tensors["self_attn.q.bias"].dtype == torch.bfloat16


def test_fp8_streamed_forward_matches_jax(bf16):
    jdit, params, model, x = bf16
    resident, stacked = joff.split_block_params(params)
    jsd = joff.StreamedDiT(jdit, resident, joff.offload_blocks_to_host(
        stacked, 2, quantize="fp8"))
    want = np.asarray(jsd(x["x"], x["t"], x["ctx"], **_kw(x)), np.float32)
    got = _streamed(model, "fp8")(
        *[torch.from_numpy(x[k]) for k in ("x", "t", "ctx")],
        **_kw(x, True)).float().numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel
    plain = np.asarray(jdit.apply(params, x["x"], x["t"], x["ctx"],
                                  **_kw(x)), np.float32)
    assert np.linalg.norm(want - plain) / np.linalg.norm(plain) > rel


def test_time_embed_e0_matches_jax(fp32):
    jdit, params, model, _ = fp32
    t = np.array([999.0, 875.5, 500.0, 3.0], np.float32)
    je, je0 = jdit.apply(params, t, method=JaxWanDiT.time_embed_e0)
    with torch.no_grad():
        e, e0 = model.time_embed_e0(torch.from_numpy(t))
    assert e0.shape == (4, 6, model.cfg.dim)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(e0.numpy(), np.asarray(je0), atol=1e-5)


COEFFS = [-5.21862437e+04, 9.23041404e+03, -5.28275948e+02,
          1.36987616e+01, -4.99875664e-02]


def _e0_sequence(n=50, d=64, seed=3):
    """A slowly drifting e0 trajectory (``tests/test_offload.py``'s)."""
    rs = np.random.RandomState(seed)
    base = rs.randn(1, 6, d).astype(np.float32)
    drift = rs.randn(1, 6, d).astype(np.float32)
    return [base * (1.0 - 0.3 * i / (n - 1)) + drift * 0.05 * i / (n - 1)
            + rs.randn(1, 6, d).astype(np.float32) * 0.003
            for i in range(n)]


@pytest.mark.parametrize("skip", [0, 2])
@pytest.mark.parametrize("thresh", [0.0, 0.10, 1e9])
def test_host_teacache_matches_jax(thresh, skip):
    seq = _e0_sequence()
    want = joff._HostTeaCache(COEFFS, thresh, skip)
    got = _HostTeaCache(COEFFS, thresh, skip)
    dec = [got.should_calc(e) for e in seq]
    assert dec == [want.should_calc(e) for e in seq]
    assert got.accum == want.accum          # float64 both
    assert [c for _, _, c in got.log] == dec
    if thresh == 0.10:
        assert not all(dec) and any(dec[2:])
    if thresh == 1e9:
        assert sum(dec) == max(skip, 1)


def test_streamed_denoise_matches_jax(fp32):
    """TeaCache (poly = 1 a step at 1.5 after 2 warm steps: calc every
    other step whatever e0 is, so the decisions cannot flip on the two
    packages' last bits) and cfg-skip 0.25 over 8 steps, the same numpy
    noise and conditioning on both sides."""
    jdit, params, model, x = fp32
    rs = np.random.RandomState(7)
    lat = rs.randn(B, LT, LH, LW, 16).astype(np.float32)
    neg = rs.randn(*x["ctx"].shape).astype(np.float32)
    coeffs, kw = (0.0, 0.0, 0.0, 0.0, 1.0), dict(guidance_scale=5.0,
                                                 cfg_skip_ratio=0.25)
    resident, stacked = joff.split_block_params(params)
    jsd = joff.StreamedDiT(jdit, resident, joff.offload_blocks_to_host(
        stacked, 2, quantize="none"))
    jtc = joff._HostTeaCache(coeffs, 1.5, 2)
    want = np.asarray(jsd.denoise(jax_get_scheduler("flow", 8, 3.0), lat,
                                  x["ctx"], neg_embeds=neg, teacache=jtc,
                                  **_kw(x), **kw))
    tc = _HostTeaCache(coeffs, 1.5, 2)
    steps = []
    got = _streamed(model, "none").denoise(
        get_scheduler("flow", 8, 3.0), torch.from_numpy(lat),
        torch.from_numpy(x["ctx"]), neg_embeds=torch.from_numpy(neg),
        teacache=tc, step_times=steps, **_kw(x, True), **kw)
    calc = [c for _, _, c in tc.log]
    assert calc == [True, True, False, True, False, True, False, True]
    assert len(steps) == 8 and tc.residual.shape[0] == B   # cond half
    assert np.abs(got.numpy() - want).max() < 1e-4
    assert not np.allclose(got.numpy(), lat)


def test_make_host_blocks_matches_jax_shapes_and_dtypes(bf16):
    jdit, _, model, _ = bf16
    _, want = joff.make_host_blocks(jdit, 2, quantize="fp8", seed=0)
    resident, got = make_host_blocks(model.cfg, 2, "fp8", "cpu", seed=0)
    assert len(got) == 2 and len(resident.blocks) == 0
    tree = jax.tree_util.tree_map(np.asarray, want[1])
    ref = {}
    _dit_block(ref, "b", jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.dtype == jnp.float8_e4m3fn)),
        tree), model.cfg)
    for n, v in got[1].tensors.items():
        assert tuple(v.shape) == tuple(ref["b." + n].shape), n
        assert (v.dtype == FP8) == bool(ref["b." + n].flatten()[0]), n
    assert set(got[1].tensors) == {n[2:] for n in ref}
    w = got[1].tensors["ffn.0.weight"].float()
    assert 0.01 < w.std().item() < 0.03 and not torch.equal(
        w, got[0].tensors["ffn.0.weight"].float())
    zeros = make_host_blocks(model.cfg, 1, "fp8", "cpu")[1][0]
    assert not zeros.flat.any()
    assert all(not p.any() for p in resident.parameters())


def _pipe(model, streamed=None, teacache=None, **cfg):
    vae = WanVAE(VAEConfig(dim=4, z_dim=16, dim_mult=(1, 1, 2, 2),
                           num_res_blocks=1,
                           temporal_downsample=(False, True, True)))
    cfg = dict(dict(num_inference_steps=3, guidance_scale=5.0, num_frames=9,
                    height=64, width=64), **cfg)
    return WanControlPipeline(model, vae, PipelineConfig(**cfg), "cpu",
                              teacache=teacache, streamed_dit=streamed)


def test_pipeline_hands_the_loop_to_the_streamed_dit(fp32):
    """Without TeaCache the streamed loop is the pipeline's loop, bit for
    bit; with it the pipeline decides through ``_HostTeaCache``."""
    _, _, model, x = fp32
    rs = np.random.RandomState(4)
    lat = torch.from_numpy(rs.randn(B, LT, LH, LW, 16).astype(np.float32))
    ctx = torch.from_numpy(x["ctx"])
    neg = torch.zeros_like(ctx)
    want = _pipe(model).denoise(lat, ctx, neg, **_kw(x, True))
    sdit = _streamed(model, "none")
    got = _pipe(sdit.model, sdit).denoise(lat, ctx, neg, **_kw(x, True))
    assert torch.equal(got, want)
    pipe = _pipe(sdit.model, sdit, TeaCacheConfig((0.0,) * 4 + (1.0,), 1.5,
                                                  1))
    pipe.denoise(lat, ctx, neg, **_kw(x, True))
    assert isinstance(pipe.teacache_state, _HostTeaCache)
    assert [c for _, _, c in pipe.teacache_state.log] == [True, False, True]


@pytest.mark.parametrize("offload", [False, True])
def test_streamed_replays_equal_the_resident_loop(fp32, offload):
    """The same decisions on both sides (a constant polynomial of 1 against
    1.5 after one warm step: calc, replay, calc, replay) and cfg-skip 0.25
    over 4 steps, so the last step replays the cond half of the residual:
    the streamed loop and the pipeline's resident loop, its residual kept
    or offloaded to host memory, give the same latents (tolerance 0)."""
    _, _, model, x = fp32
    rs = np.random.RandomState(5)
    lat = torch.from_numpy(rs.randn(B, LT, LH, LW, 16).astype(np.float32))
    ctx = torch.from_numpy(x["ctx"])
    neg = torch.from_numpy(rs.randn(*x["ctx"].shape).astype(np.float32))
    tc = TeaCacheConfig((0.0,) * 4 + (1.0,), 1.5, 1, offload_residual=offload)
    cfg = dict(num_inference_steps=4, cfg_skip_ratio=0.25)
    sdit = _streamed(model, "none")
    streamed = _pipe(sdit.model, sdit, tc, **cfg)
    want = streamed.denoise(lat, ctx, neg, **_kw(x, True))
    resident = _pipe(model, None, tc, **cfg)
    got = resident.denoise(lat, ctx, neg, **_kw(x, True))
    for pipe in (streamed, resident):
        assert [c for _, _, c in pipe.teacache_state.log] == \
            [True, False, True, False]
    assert torch.equal(got, want)
    every_step = _pipe(model, **cfg).denoise(lat, ctx, neg, **_kw(x, True))
    assert not torch.equal(got, every_step)


def test_unpinned_host_blocks_raise_on_the_card(bf16, monkeypatch):
    """On the card a pageable source would make every copy synchronous:
    StreamedDiT refuses it before it allocates anything."""
    _, _, model, _ = bf16
    resident, blocks = split_block_params(copy.deepcopy(model))
    host = offload_blocks_to_host(blocks, "fp8", "cpu")
    monkeypatch.setattr(offload, "resolve_device",
                        lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="pinned"):
        StreamedDiT(resident, host, "cuda")


@pytest.mark.parametrize("fn", [StreamedDiT.__init__, make_host_blocks,
                                offload_blocks_to_host],
                         ids=["StreamedDiT", "make_host_blocks",
                              "offload_blocks_to_host"])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("size", ["1.3b", "14b"])
@pytest.mark.parametrize("variant", [
    dict(motion_guidance=True, in_dim=64), dict(in_dim=36)],
    ids=["motion_64", "inp_36"])
def test_dit_forward_flops_match_jax(size, variant):
    jmake = {"1.3b": jax_dit_1_3b, "14b": jax_dit_14b}[size]
    tmake = {"1.3b": tconfig.dit_1_3b, "14b": tconfig.dit_14b}[size]
    kw = dict(variant, model_type="i2v")
    mg = kw.pop("motion_guidance", False)
    jcfg, tcfg = jmake(motion_guidance=mg, **kw), tmake(
        motion_guidance=mg, **kw)
    for tokens, batch in ((9568, 2), (1234, 1)):
        assert dit_forward_flops(tcfg, tokens, batch) == jax_flops(
            jcfg, tokens, batch)
    assert dit_forward_flops(tcfg, 9568, 1, num_layers=3) == jax_flops(
        jcfg, 9568, 1, num_layers=3)
