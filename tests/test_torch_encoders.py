"""The port's conditioning towers (umT5, CLIP's vision tower, OmniMAE), its
cubic resize and its encoder builders against the JAX package on the CPU,
at tiny widths in fp32.

Weights go both ways: JAX params drawn from a numpy seed carried to the port
by ``more4d_tpu_torch.convert`` ("jax_to_port"), and the port's own
``init_weights`` carried to JAX by the JAX converters ("port_to_jax").
Tolerance on every tower: max-abs <= 1e-5 x max(1, max |JAX output|) (the
same fp32 formulas, sums ordered differently). The resizes: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from more4d_tpu.config import CLIPVisionConfig as JaxClipCfg
from more4d_tpu.config import T5Config as JaxT5Cfg
from more4d_tpu.models import clip as jclip
from more4d_tpu.models import omnimae as jomni
from more4d_tpu.models import t5 as jt5
from more4d_tpu_torch import convert
from more4d_tpu_torch.config import CLIPVisionConfig, T5Config
from more4d_tpu_torch.infer.encoders import (build_clip_encoder,
                                             build_encoders,
                                             build_mpm_extractor,
                                             build_text_encoder)
from more4d_tpu_torch.models import clip as tclip
from more4d_tpu_torch.models import omnimae as tomni
from more4d_tpu_torch.models import t5 as tt5
from more4d_tpu_torch.nn.resize import resize

DIRECTIONS = ["jax_to_port", "port_to_jax"]
T5 = dict(vocab=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
          num_layers=2, num_buckets=8, text_len=9)
CLIP = dict(image_size=28, patch_size=14, dim=32, num_heads=2, num_layers=3)
OMNI = dict(embed_dim=32, depth=2, num_heads=2, image_size=32)


def random_params(init, seed, *args, **kw):
    """JAX params of the shapes ``init`` makes, drawn from a numpy seed:
    kernels N(0, 1/fan_in), 1-D scales 1 + N(0, 0.1^2), 1-D biases
    N(0, 0.1^2)."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args, **kw)
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if len(leaf.shape) >= 2:
            std = float(np.prod(leaf.shape[:-1])) ** -0.5
            return np.asarray(rs.normal(0, std, leaf.shape), np.float32)
        base = 1.0 if name in ("scale", "weight") else 0.0
        return np.asarray(base + rs.normal(0, 0.1, leaf.shape), np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def paired(direction, jax_init, jax_args, port_module, to_port, to_jax,
           seed=0):
    """(JAX params, the port module) holding the same weights."""
    if direction == "jax_to_port":
        params = random_params(jax_init, seed, *jax_args)
        port_module.load_state_dict(to_port(params), strict=True)
    else:
        port_module.init_weights(torch.Generator().manual_seed(seed))
        params = to_jax(port_module.state_dict())
    return params, port_module.eval()


# ------------------------------------------------------------------ umT5

def t5_inputs():
    rs = np.random.RandomState(1)
    ids = rs.randint(0, T5["vocab"], (3, 9))
    mask = np.zeros((3, 9), np.float32)
    mask[0, :7] = 1
    mask[1, :3] = 1                      # row 2: all masked (uniform)
    return ids, mask


@pytest.mark.parametrize("shared_pos", [False, True])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_t5_matches_jax_with_padded_mask(direction, shared_pos):
    jcfg = JaxT5Cfg(dtype=jnp.float32, shared_pos=shared_pos, **T5)
    tcfg = T5Config(dtype=torch.float32, shared_pos=shared_pos, **T5)
    ids, mask = t5_inputs()
    jmodel = jt5.WanT5Encoder(jcfg)
    params, model = paired(
        direction, jmodel.init, (jnp.asarray(ids), jnp.asarray(mask)),
        tt5.WanT5Encoder(tcfg), lambda p: convert.t5_state_dict(p, tcfg),
        lambda sd: jt5.convert_t5_state_dict(sd, jcfg))
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    close(got, want)


def test_relative_position_buckets_copy():
    for lq, lk, nb in ((9, 9, 8), (512, 512, 32), (7, 300, 32)):
        np.testing.assert_array_equal(
            tt5.relative_position_buckets(lq, lk, nb),
            jt5.relative_position_buckets(lq, lk, nb))


# ------------------------------------------------------------------ CLIP

@pytest.mark.parametrize("direction", DIRECTIONS)
def test_clip_matches_jax(direction):
    jcfg = JaxClipCfg(dtype=jnp.float32, **CLIP)
    tcfg = CLIPVisionConfig(dtype=torch.float32, **CLIP)
    jmodel = jclip.ClipVisionTower(jcfg)
    x0 = jnp.zeros((1, 28, 28, 3))
    params, model = paired(
        direction, jmodel.init, (x0,), tclip.ClipVisionTower(tcfg),
        lambda p: convert.clip_vision_state_dict(p, tcfg),
        lambda sd: jclip.convert_clip_vision_state_dict(
            {"visual." + k: v for k, v in sd.items()}, jcfg))
    images = np.random.RandomState(2).uniform(-1, 1, (2, 40, 36, 3)
                                              ).astype(np.float32)
    want = jclip.encode_image(jmodel, params, jnp.asarray(images))
    with torch.no_grad():
        got = tclip.encode_image(model, torch.from_numpy(images))
    assert got.shape == (2, 5, 32)                  # cls + 4 patches
    close(got, want)


# --------------------------------------------------------------- OmniMAE

@pytest.mark.parametrize("direction", DIRECTIONS)
def test_omnimae_matches_jax(direction):
    jmodel = jomni.OmniMAEViT(**OMNI)
    params, model = paired(
        direction, jmodel.init, (jnp.zeros((1, 32, 32, 3)),),
        tomni.OmniMAEViT(**OMNI),
        lambda p: convert.omnimae_state_dict(p, OMNI["depth"]),
        lambda sd: jomni.convert_omnimae_state_dict(sd, OMNI["depth"]))
    images = np.random.RandomState(3).rand(2, 48, 40, 3).astype(np.float32)
    tokens, pooled = jomni.extract_mpm_features(jmodel, params,
                                                jnp.asarray(images))
    with torch.no_grad():
        got, got_pooled = tomni.extract_mpm_features(
            model, torch.from_numpy(images))
    assert got.shape == (2, 4, 32)
    close(got, tokens)
    close(got_pooled, pooled)


def test_sinusoid_table_and_variants_copy():
    np.testing.assert_array_equal(tomni.sinusoid_table(196, 768),
                                  jomni.sinusoid_table(196, 768))
    assert tomni.OMNIMAE_VARIANTS == {
        k: dict(v) for k, v in jomni.OMNIMAE_VARIANTS.items()}
    for variant in tomni.OMNIMAE_VARIANTS:
        with torch.device("meta"):
            sd = tomni.omnimae_vit(variant).state_dict()
        assert tomni.infer_omnimae_variant(sd) == variant
        assert jomni.infer_omnimae_variant(sd) == variant


# ----------------------------------------------------- round trips, exact

def _round_trip(module, to_jax, to_port):
    module.init_weights(torch.Generator().manual_seed(5))
    sd = module.state_dict()
    back = to_port(to_jax(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("tower", ["t5", "t5_shared_pos", "clip",
                                   "omnimae"])
def test_state_dict_round_trips_exactly(tower):
    if tower.startswith("t5"):
        shared = tower.endswith("shared_pos")
        jcfg = JaxT5Cfg(shared_pos=shared, **T5)
        tcfg = T5Config(dtype=torch.float32, shared_pos=shared, **T5)
        _round_trip(tt5.WanT5Encoder(tcfg),
                    lambda sd: jt5.convert_t5_state_dict(sd, jcfg),
                    lambda p: convert.t5_state_dict(p, tcfg))
    elif tower == "clip":
        tcfg = CLIPVisionConfig(**CLIP)
        _round_trip(tclip.ClipVisionTower(tcfg),
                    lambda sd: jclip.convert_clip_vision_state_dict(
                        {"visual." + k: v for k, v in sd.items()},
                        JaxClipCfg(**CLIP)),
                    lambda p: convert.clip_vision_state_dict(p, tcfg))
    else:
        _round_trip(tomni.OmniMAEViT(**OMNI),
                    lambda sd: jomni.convert_omnimae_state_dict(sd, 2),
                    lambda p: convert.omnimae_state_dict(p, 2))


# ----------------------------------------------------------- cubic resize

@pytest.mark.parametrize("src,dst", [
    ((2, 368, 512, 3), (2, 224, 224, 3)),          # CLIP on stage-2 renders
    ((1, 512, 512, 3), (1, 224, 224, 3)),          # CLIP on the grey image
    ((1, 37, 37, 64), (1, 31, 44, 64)),            # DINOv2 position table
], ids=["clip_renders", "clip_grey", "pos_table"])
def test_cubic_resize_matches_jax_image_resize(src, dst):
    x = np.random.RandomState(0).randn(*src).astype(np.float32)
    want = np.asarray(jax.image.resize(x, dst, "bicubic"))
    got = resize(torch.from_numpy(x), dst, "cubic").numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-5


def test_bicubic_interpolate_would_not_match():
    """Why the port builds its own cubic weights: F.interpolate's plain
    bicubic (a = -0.75, no antialias when it downsamples) misses JAX's by
    far at both of the path's bicubic resizes."""
    rs = np.random.RandomState(1)
    for src, dst in (((1, 368, 512, 3), (224, 224)),
                     ((1, 37, 37, 64), (31, 44))):
        x = rs.rand(*src).astype(np.float32)
        want = np.asarray(jax.image.resize(x, src[:1] + dst + src[3:],
                                           "bicubic"))
        naive = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                              size=dst, mode="bicubic",
                              align_corners=False).permute(0, 2, 3, 1)
        assert np.abs(naive.numpy() - want).max() > 0.1


def test_omnimae_bilinear_resize_would_not_match_plain_interpolate():
    """OmniMAE's 368x512 -> 224 bilinear resize goes through the
    antialiased ``resize``; plain F.interpolate misses it."""
    x = np.random.RandomState(2).rand(1, 368, 512, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, 224, 224, 3), "bilinear"))
    got = resize(torch.from_numpy(x), (1, 224, 224, 3)).numpy()
    naive = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                          size=(224, 224), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() < 1e-5
    assert np.abs(naive - want).max() > 0.1


# -------------------------------------------------------------- builders

def stand_in_tokenize(prompts):
    """Seeded ids, one a word plus an end token, no padding (the builder
    pads)."""
    n = max(len(p.split()) + 1 for p in prompts)
    ids = np.zeros((len(prompts), n), np.int64)
    mask = np.zeros((len(prompts), n), np.float32)
    for i, p in enumerate(prompts):
        k = len(p.split()) + 1
        ids[i, :k] = np.random.RandomState(k).randint(1, T5["vocab"], k)
        mask[i, :k] = 1
    return ids, mask


def test_text_encoder_pads_and_zeroes_past_each_prompt():
    tcfg = T5Config(dtype=torch.float32, **T5)
    jcfg = JaxT5Cfg(dtype=jnp.float32, **T5)
    t5 = tt5.WanT5Encoder(tcfg).init_weights(torch.Generator().manual_seed(0))
    encode = build_text_encoder(t5.state_dict(), stand_in_tokenize, tcfg,
                                device="cpu")
    prompts = ["a cat walking on grass", "", "dog"]
    got = encode(prompts)
    assert got.shape == (3, T5["text_len"], T5["dim"])
    assert got[0, 6:].abs().max() == 0 and got[0, 5].abs().max() > 0
    assert got[1, 1:].abs().max() == 0 and got[2, 2:].abs().max() == 0
    # JAX's build_text_encoder closure on the same ids, padded to text_len
    ids, mask = stand_in_tokenize(prompts)
    pad = ((0, 0), (0, T5["text_len"] - ids.shape[1]))
    ids, mask = np.pad(ids, pad), np.pad(mask, pad)
    params = jt5.convert_t5_state_dict(t5.state_dict(), jcfg)
    emb = jt5.WanT5Encoder(jcfg).apply(params, jnp.asarray(ids),
                                       jnp.asarray(mask))
    close(got, emb * mask[..., None])


def test_clip_builder_takes_visual_blocks_and_names_the_rest(tmp_path,
                                                             capsys):
    tcfg = CLIPVisionConfig(dtype=torch.float32, **CLIP)
    tower = tclip.ClipVisionTower(tcfg).init_weights(
        torch.Generator().manual_seed(1))
    ckpt = {"visual." + k: v for k, v in tower.state_dict().items()}
    ckpt.update({"visual.transformer.2.attn.to_qkv.weight": torch.zeros(1),
                 "visual.head": torch.zeros(1),
                 "textual.token_embedding.weight": torch.zeros(1),
                 "log_scale": torch.zeros(())})
    torch.save(ckpt, tmp_path / "clip.pth")
    encode = build_clip_encoder(str(tmp_path / "clip.pth"), tcfg,
                                device="cpu")
    assert "CLIP: 4 checkpoint keys not used" in capsys.readouterr().out
    images = torch.rand(1, 30, 30, 3) * 2 - 1
    with torch.no_grad():
        want = tclip.encode_image(tower.eval(), images)
    torch.testing.assert_close(encode(images), want, rtol=0, atol=0)
    # a checkpoint that lacks a key the tower needs is refused
    del ckpt["visual.pre_norm.bias"]
    with pytest.raises(RuntimeError, match="pre_norm.bias"):
        build_clip_encoder(ckpt, tcfg, device="cpu")


def test_build_encoders_bundle_and_dummy_text():
    omni = tomni.OmniMAEViT(**OMNI).init_weights(
        torch.Generator().manual_seed(2))
    with pytest.raises(ValueError, match="allow_dummy_text"):
        build_encoders(device="cpu")
    enc = build_encoders(omnimae=omni, text_dim=16, text_len=8,
                         allow_dummy_text=True,
                         weight_dtype=torch.bfloat16, device="cpu")
    assert enc.encode_clip is None
    assert enc.encode_text(["a", "b"]).abs().max() == 0
    assert enc.encode_text(["a"]).shape == (1, 8, 16)
    tokens = enc.extract_mpm(torch.rand(1, 40, 40, 3))
    assert tokens.shape == (1, 4, 32)
    assert next(omni.parameters()).dtype == torch.bfloat16
    mpm = build_mpm_extractor(omni, device="cpu")
    assert mpm(torch.rand(1, 40, 40, 3)).shape == (1, 4, 32)
