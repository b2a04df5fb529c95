"""The port's UniDepth-V2 depth lift (DINOv2 backbone, camera and depth
heads, the provider) and its depth providers against the JAX package on
the CPU, at tiny widths in fp32.

Weights go both ways, as in ``test_torch_encoders.py``: JAX params from a
numpy seed through ``more4d_tpu_torch.convert``, and the port's
``init_weights`` through the JAX converters. Tolerance: max-abs <= 1e-5 x
max(1, max |JAX output|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.models import dinov2 as jdino
from more4d_tpu.models import unidepth as jud
from more4d_tpu_torch import convert
from more4d_tpu_torch.models import depth as tdepth
from more4d_tpu_torch.models import dinov2 as tdino
from more4d_tpu_torch.models import unidepth as tud
from test_torch_encoders import DIRECTIONS, close, paired

DINO = dict(embed_dim=32, depth=3, num_heads=2, pos_grid=5)
UD = dict(backbone_dim=32, backbone_depth=2, backbone_heads=2, hidden_dim=32,
          layer_ids=(0, 1))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_dinov2_intermediate_layers_non_square_grid(direction):
    """56x84 input: a 4x6 grid, so the 5x5 position table goes through the
    bicubic resize; blocks 0 and 2, final-normed."""
    jmodel = jdino.DinoV2ViT(**DINO)
    params, model = paired(
        direction, jmodel.init, (jnp.zeros((1, 70, 70, 3)),),
        tdino.DinoV2ViT(**DINO),
        lambda p: convert.dinov2_state_dict(p, DINO["depth"]),
        lambda sd: jdino.convert_dinov2_state_dict(sd, DINO["depth"]))
    x = np.random.RandomState(0).randn(2, 56, 84, 3).astype(np.float32)
    want, grid = jmodel.apply(params, jnp.asarray(x), layer_ids=[2, 0],
                              method=jdino.DinoV2ViT.get_intermediate_layers)
    with torch.no_grad():
        got, tgrid = model.get_intermediate_layers(torch.from_numpy(x),
                                                   [2, 0])
    assert tuple(tgrid) == tuple(grid) == (4, 6)
    assert len(got) == len(want) == 2
    for (gp, gc), (wp, wc) in zip(got, want):
        assert gp.shape == (2, 24, 32)
        close(gp, wp)
        close(gc, wc)
    # the whole backbone: every block, then the final norm
    want, _ = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(x))
    close(got, want)


def tiny_pair(direction, seed=0):
    jmodel = jud.UniDepthV2(**UD)
    params, model = paired(
        direction, jmodel.init, (jnp.zeros((1, 56, 70, 3)),),
        tud.UniDepthV2(**UD),
        lambda p: convert.unidepth_state_dict(p, UD["backbone_depth"]),
        lambda sd: jud.convert_unidepth_state_dict(
            sd, num_adapters=2, backbone_depth=UD["backbone_depth"]), seed)
    return jmodel, params, model


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_unidepth_decoder_matches_jax(direction):
    """The decoder alone (adapters, camera head, SH ray prompt, depth head
    with its transposed convs) on the same per-level tokens."""
    jmodel, params, model = tiny_pair(direction)
    gh, gw = 3, 5
    rs = np.random.RandomState(1)
    levels = [rs.randn(2, gh * gw, 32).astype(np.float32) for _ in range(2)]
    depth, k_mat = jmodel.apply(params, [(jnp.asarray(l), None)
                                         for l in levels], gh * 14, gw * 14,
                                (gh, gw), method=jud.UniDepthV2.decode)
    with torch.no_grad():
        got_d, got_k = model.decode([(torch.from_numpy(l), None)
                                     for l in levels], gh * 14, gw * 14,
                                    (gh, gw))
    assert got_d.shape == (2, 4 * gh, 4 * gw)
    close(got_k, k_mat)
    close(got_d, depth)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_unidepth_provider_matches_jax(direction):
    """The whole provider: preprocess (bilinear resize to the pixel budget,
    multiples of 14, ImageNet normalisation), backbone, decoder, and the
    depth resized back to the image."""
    jmodel, params, model = tiny_pair(direction, seed=3)
    img = np.random.RandomState(2).rand(37, 53, 3).astype(np.float32)
    want = jud.JaxUniDepthProvider(params=params, model=jmodel,
                                   pixel_budget=56 * 70)(img)
    got = tud.UniDepthProvider(model=model, pixel_budget=56 * 70,
                               device="cpu")(img)
    assert got.shape == (37, 53) and (got > 0).all()
    close(got, want)
    # the preprocess at the operating point: 368x512 -> 434x616 (31x44)
    x, hw = tud.preprocess(torch.rand(368, 512, 3))
    jx, jhw = jud.preprocess(np.random.rand(368, 512, 3).astype(np.float32))
    assert tuple(x.shape) == tuple(jx.shape) == (1, 434, 616, 3)
    assert hw == tuple(jhw) == (368, 512)


def test_unidepth_state_dict_round_trips_exactly():
    model = tud.UniDepthV2(**UD).init_weights(
        torch.Generator().manual_seed(4))
    sd = model.state_dict()
    assert sorted(k for k in sd if not k.startswith("pixel_encoder.")) == \
        sorted(jud.unidepth_decoder_key_manifest(num_adapters=2))
    back = convert.unidepth_state_dict(jud.convert_unidepth_state_dict(
        sd, num_adapters=2, backbone_depth=2), 2)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_spherical_harmonics_and_rays_match_jax():
    rs = np.random.RandomState(5)
    d = rs.randn(50, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.astype(np.float32)
    close(tud.spherical_harmonics(torch.from_numpy(d)),
          jud.spherical_harmonics(jnp.asarray(d)))
    k_mat = np.array([[[100.0, 0, 32], [0, 90.0, 24], [0, 0, 1]]],
                     np.float32)
    close(tud.rays_from_intrinsics(torch.from_numpy(k_mat), 6, 8, 48, 64),
          jud.rays_from_intrinsics(jnp.asarray(k_mat), 6, 8, 48, 64))


def test_depth_providers(tmp_path):
    img = np.zeros((4, 6, 3), np.float32)
    const = tdepth.get_depth_provider("constant", depth=3.0)(img)
    assert const.shape == (4, 6) and (const == 3.0).all()
    np.save(tmp_path / "frame.npy", np.full((4, 6), 2.5))
    pre = tdepth.get_depth_provider("precomputed", directory=str(tmp_path))
    with pytest.raises(ValueError, match="set_current"):
        pre(img)
    pre.set_current("frame")
    assert pre(img).dtype == np.float32 and (pre(img) == 2.5).all()
    model = tud.UniDepthV2(**UD).init_weights(
        torch.Generator().manual_seed(0))
    native = tdepth.get_depth_provider("unidepth_native", model=model,
                                       pixel_budget=28 * 42, device="cpu")
    assert native(img).shape == (4, 6)
    # a checkpoint (decoder keys under pixel_decoder.) into a fresh graph
    sd = {("pixel_decoder." + k if not k.startswith("pixel_encoder.")
           else k): v for k, v in model.state_dict().items()}
    torch.save({"state_dict": sd}, tmp_path / "unidepth.pth")
    loaded = tdepth.get_depth_provider(
        "unidepth_native", model=tud.UniDepthV2(**UD), pixel_budget=28 * 42,
        ckpt=str(tmp_path / "unidepth.pth"), device="cpu")
    torch.testing.assert_close(loaded(img), native(img), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="unidepth_native"):
        tdepth.get_depth_provider("unidepth")
    with pytest.raises(ValueError, match="unknown"):
        tdepth.get_depth_provider("midas")
