"""The port's checkpoint loaders against the JAX package's on the CPU, on
synthetic checkpoints in the released key layout (tiny widths, fp32).

- the Wan DiT through both packages from sharded ``.safetensors`` (written
  by ``safetensors.numpy``, as the JAX package writes them), one
  ``.safetensors`` and a ``.pth``, including the 48->64 patch-embedding
  surgery and the fresh FiLM and xavier convs: bit-identical to
  ``convert.dit_state_dict`` of the JAX params;
- the strict loader's four error classes in both packages;
- the VAE (with and without the ``model.`` prefix) and the decoder
  adaptor: bit-identical;
- UniDepth checkpoints with ``pixel_encoder.mask_token``, encoder-only,
  or under ``transformers`` DINOv2 names, and the OmniMAE trunk spelt
  ``patch_embed.proj.*``: the weights the JAX converters produce;
- the umT5 and CLIP towers built on the meta device from a checkpoint;
- the ``.safetensors`` reader and writer against ``safetensors.torch``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.convert import dit_torch as jdt
from more4d_tpu.convert.vae_torch import load_wan_vae as jax_load_wan_vae
from more4d_tpu.models import omnimae as jomni
from more4d_tpu.models import unidepth as jud
from more4d_tpu.models.adaptors import load_adaptor as jax_load_adaptor
from more4d_tpu_torch import convert
from more4d_tpu_torch.config import (CLIPVisionConfig, T5Config, VAEConfig,
                                     dit_tiny)
from more4d_tpu_torch.convert import dit_torch as tdt
from more4d_tpu_torch.convert.vae_torch import load_wan_vae
from more4d_tpu_torch.infer import encoders as tenc
from more4d_tpu_torch.models import (VAEDecoderAdaptor, WanDiT, WanVAE,
                                     omnimae as tomni)
from more4d_tpu_torch.models import unidepth as tud
from more4d_tpu_torch.models.adaptors import load_adaptor
from more4d_tpu_torch.train.checkpoint import CheckpointManager
from more4d_tpu_torch.utils import safetensors_io
from test_torch_unidepth import UD

VAE_TINY = dict(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
                temporal_downsample=(False, True, True))
VARIANTS = {
    # a released 48-channel Control checkpoint into the 4D config
    "control4d": dict(motion_guidance=True, in_dim=64, model_type="i2v"),
    "inp": dict(motion_guidance=False, in_dim=36, model_type="i2v"),
}


def released_dit(in_dim, seed=0):
    """A released-layout 3D DiT state dict (no 4D groups) from the port's
    module, every weight non-zero."""
    g = torch.Generator().manual_seed(seed)
    sd = WanDiT(dit_tiny(motion_guidance=False, in_dim=in_dim,
                         model_type="i2v")).state_dict()
    return {k: torch.randn(v.shape, generator=g) * 0.05 for k, v in sd.items()}


def write(sd, path, fmt):
    """``sd`` as two shards (safetensors.numpy), one .safetensors, or a
    .pth; returns what the loaders take."""
    from safetensors.numpy import save_file

    np_sd = {k: v.numpy() for k, v in sd.items()}
    if fmt == "shards":
        os.makedirs(path)
        keys = sorted(np_sd)
        for i, part in enumerate((keys[:len(keys) // 2],
                                  keys[len(keys) // 2:])):
            save_file({k: np_sd[k] for k in part}, os.path.join(
                path, f"diffusion_pytorch_model-0000{i + 1}-of-00002"
                      f".safetensors"))
        return path
    if fmt == "single":
        save_file(np_sd, path + ".safetensors")
        return path + ".safetensors"
    torch.save(sd, path + ".pth")
    return path + ".pth"


def assert_equal_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("fmt", ["shards", "single", "pth"])
def test_dit_load_bit_identical_to_jax(tmp_path, fmt, variant):
    kw = VARIANTS[variant]
    sd = released_dit(48 if variant == "control4d" else kw["in_dim"])
    path = write(sd, str(tmp_path / "dit"), fmt)
    want = convert.dit_state_dict(
        jdt.load_wan_dit(path, jax_dit_tiny(dtype=jnp.float32, **kw)),
        dit_tiny(**kw))
    got = tdt.load_wan_dit(path, dit_tiny(**kw))
    assert_equal_sd(got, want)
    if variant == "control4d":
        pe = got["patch_embedding.weight"]
        assert pe.shape[1] == 64 and torch.equal(pe[:, :48],
                                                 sd["patch_embedding.weight"])
        assert not pe[:, 48:].any()
        assert not got["blocks.1.spatial_guidance_ffn.gate"].any()
        assert got["feature_adapter.0.weight"].abs().max() > 0
    WanDiT(dit_tiny(**kw)).load_state_dict(got, strict=True)


def test_strict_loader_matches_jax_and_reports_surgery():
    kw = VARIANTS["control4d"]
    sd = released_dit(48, seed=1)
    want, want_report = jdt.load_wan_dit_strict(
        sd, jax_dit_tiny(dtype=jnp.float32, **kw))
    got, report = tdt.load_wan_dit_strict(sd, dit_tiny(**kw))
    assert_equal_sd(got, convert.dit_state_dict(want, dit_tiny(**kw)))
    assert report == want_report
    assert report["ckpt_in_dim"] == 48 and report["model_in_dim"] == 64
    assert "fresh-init" in report["groups"]["spatial_guidance"]


@pytest.mark.parametrize("variant", [
    dict(motion_guidance=True, in_dim=64), dict(motion_guidance=False,
                                                in_dim=36),
    dict(motion_guidance=True, in_dim=64, ref_conv=True)])
def test_manifest_is_jax_manifest_and_model_keys(variant):
    req, opt = tdt.wan_dit_key_manifest(dit_tiny(**variant))
    assert (req, opt) == jdt.wan_dit_key_manifest(jax_dit_tiny(**variant))
    keys = set(tdt.model_state_shapes(dit_tiny(**variant)))
    assert keys == set(req) | {k for g in opt.values() for k in g}


def _broken(case):
    sd = released_dit(48, seed=2)
    if case == "missing":
        sd["blocks.0.self_attn.q.weight_RENAMED"] = sd.pop(
            "blocks.0.self_attn.q.weight")
        return sd, ["blocks.0.self_attn.q.weight", "weight_RENAMED"]
    if case == "unconsumed":
        sd["blocks.0.extra.weight"] = torch.zeros(3)
        return sd, ["does NOT consume", "blocks.0.extra.weight"]
    if case == "partial_group":
        sd["blocks.1.spatial_guidance_ffn.gate"] = torch.zeros(128)
        return sd, ["PARTIALLY present", "blocks.0.spatial_guidance_self"]
    sd["head.head.weight"] = torch.zeros(7, 7)
    return sd, ["shape mismatch", "head"]


@pytest.mark.parametrize("case", ["missing", "unconsumed", "partial_group",
                                  "shape"])
def test_strict_loader_errors_match_jax(case):
    sd, words = _broken(case)
    kw = VARIANTS["control4d"]
    with pytest.raises(ValueError) as want:
        jdt.load_wan_dit_strict(sd, jax_dit_tiny(dtype=jnp.float32, **kw))
    with pytest.raises(ValueError) as got:
        tdt.load_wan_dit_strict(sd, dit_tiny(**kw))
    for w in words:
        assert w in str(want.value) and w in str(got.value), w


def test_dit_from_port_checkpoint_dir_prefers_ema(tmp_path):
    cfg = dit_tiny(**VARIANTS["inp"])
    params = released_dit(36, seed=3)
    ema = {k: v + 1.0 for k, v in params.items()}
    CheckpointManager(str(tmp_path / "a")).save(7, params, ema=ema)
    assert_equal_sd(tdt.load_wan_dit(str(tmp_path / "a"), cfg), params)
    assert_equal_sd(tdt.load_wan_dit(str(tmp_path / "a"), cfg,
                                     prefer_ema=True), ema)
    CheckpointManager(str(tmp_path / "b")).save(7, params)
    assert_equal_sd(tdt.load_wan_dit(str(tmp_path / "b"), cfg,
                                     prefer_ema=True), params)
    os.makedirs(tmp_path / "orbax" / "100" / "params")
    with pytest.raises(NotImplementedError, match="orbax"):
        tdt.load_wan_dit(str(tmp_path / "orbax"), cfg)


@pytest.mark.parametrize("fmt", ["pth_model_prefix", "safetensors"])
def test_vae_load_bit_identical_to_jax(tmp_path, fmt):
    cfg = VAEConfig(**VAE_TINY)
    vae = WanVAE(cfg).init_weights(torch.Generator().manual_seed(0))
    sd = {k: v + 0.01 for k, v in vae.state_dict().items()}
    if fmt == "safetensors":
        path = str(tmp_path / "vae.safetensors")
        safetensors_io.save_file(sd, path)
    else:
        path = str(tmp_path / "vae.pth")
        torch.save({"model." + k: v for k, v in sd.items()}, path)
    want = convert.vae_state_dict(
        jax_load_wan_vae(path, JaxVAEConfig(**VAE_TINY)), cfg)
    assert_equal_sd(load_wan_vae(path, cfg), want)
    assert_equal_sd(want, sd)


def test_adaptor_load_bit_identical_to_jax(tmp_path):
    dec = VAEDecoderAdaptor(ch=64)
    sd = {k: v + 0.01 for k, v in dec.state_dict().items()}
    torch.save(sd, tmp_path / "dec.bin")
    params, none = jax_load_adaptor(str(tmp_path / "dec.bin"), decoder=True)
    got, vae_ft = load_adaptor(str(tmp_path / "dec.bin"), decoder=True)
    assert none is None and vae_ft is None
    assert_equal_sd(got, convert.adaptor_state_dict(params, decoder=True))
    # a checkpoint directory of the port's trainers, with a VAE patch
    patch = {"decoder.head.2.bias": torch.ones(3)}
    CheckpointManager(str(tmp_path / "ck")).save(
        1, {"enc": {}, "dec": sd, "vae_decoder": patch})
    got, vae_ft = load_adaptor(str(tmp_path / "ck"), decoder=True)
    assert_equal_sd(got, sd) and vae_ft == patch


# ------------------------------------------------------------- UniDepth

def unidepth_checkpoint(seed=0):
    model = tud.UniDepthV2(**UD).init_weights(
        torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def to_transformers_names(sd, depth):
    """The backbone under ``transformers`` ``Dinov2Model`` names (q, k, v
    split)."""
    out = {k: v for k, v in sd.items() if not k.startswith("pixel_encoder.")}
    e = {k[len("pixel_encoder."):]: v for k, v in sd.items()
         if k.startswith("pixel_encoder.")}
    p = "pixel_encoder."
    ren = {"patch_embed.proj": "embeddings.patch_embeddings.projection",
           "norm": "layernorm"}
    for old, new in ren.items():
        for s in ("weight", "bias"):
            out[f"{p}{new}.{s}"] = e[f"{old}.{s}"]
    out[p + "embeddings.cls_token"] = e["cls_token"]
    out[p + "embeddings.position_embeddings"] = e["pos_embed"]
    for i in range(depth):
        o, t = f"blocks.{i}", f"{p}encoder.layer.{i}"
        for s in ("weight", "bias"):
            for a, b in (("norm1", "norm1"), ("norm2", "norm2"),
                         ("attn.proj", "attention.output.dense"),
                         ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                out[f"{t}.{b}.{s}"] = e[f"{o}.{a}.{s}"]
            for n, part in zip(("query", "key", "value"),
                               e[f"{o}.attn.qkv.{s}"].chunk(3)):
                out[f"{t}.attention.attention.{n}.{s}"] = part
        out[f"{t}.layer_scale1.lambda1"] = e[f"{o}.ls1.gamma"]
        out[f"{t}.layer_scale2.lambda1"] = e[f"{o}.ls2.gamma"]
    return out


def jax_converted(sd):
    """The port's names of what the JAX converter makes of ``sd``."""
    params = jud.convert_unidepth_state_dict(
        sd, num_adapters=2, backbone_depth=UD["backbone_depth"])
    return convert.unidepth_state_dict(params, UD["backbone_depth"])


@pytest.mark.parametrize("case", ["mask_token", "encoder_only",
                                  "transformers_names"])
def test_unidepth_provider_loads_what_jax_converts(tmp_path, case):
    """The three checkpoints the port's provider refused (strict
    ``load_state_dict``) and the JAX provider's converter takes."""
    sd = unidepth_checkpoint()
    if case == "mask_token":
        sd["pixel_encoder.mask_token"] = torch.zeros(1, 32)
    elif case == "encoder_only":
        sd = {k: v for k, v in sd.items() if k.startswith("pixel_encoder.")}
    else:
        sd = to_transformers_names(sd, UD["backbone_depth"])
        sd["pixel_encoder.embeddings.mask_token"] = torch.zeros(1, 32)
    torch.save({"state_dict": sd}, tmp_path / "ud.pth")
    model = tud.UniDepthV2(**UD).init_weights(
        torch.Generator().manual_seed(9))
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if not k.startswith("pixel_encoder.")}
    provider = tud.UniDepthProvider(model=model, ckpt=str(tmp_path /
                                                          "ud.pth"),
                                    pixel_budget=28 * 42, device="cpu")
    got = provider.model.state_dict()
    want = jax_converted(sd) if case != "encoder_only" else {
        "pixel_encoder." + k: v for k, v in convert.dinov2_state_dict(
            jud.convert_unidepth_state_dict(
                sd, backbone_depth=UD["backbone_depth"])["params"][
                "pixel_encoder"], UD["backbone_depth"]).items()}
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if case == "encoder_only":
        for k, v in heads.items():
            assert torch.equal(got[k], v), k
        assert provider.load_report["decoder"] == "kept"
    assert provider(np.zeros((4, 6, 3), np.float32)).shape == (4, 6)


def test_unidepth_strict_loader_fails_loudly_as_jax():
    sd = unidepth_checkpoint()
    assert tud.unidepth_decoder_key_manifest(2) == \
        jud.unidepth_decoder_key_manifest(2)
    sd["depth_head.out.weight_X"] = sd.pop("depth_head.out.weight")
    sd["pixel_encoder.blocks.0.extra"] = torch.zeros(2)
    with pytest.raises(ValueError) as want:
        jud.load_unidepth_strict(sd, jud.UniDepthV2(**UD), num_adapters=2)
    with pytest.raises(ValueError) as got:
        tud.load_unidepth_strict(sd, tud.UniDepthV2(**UD))
    for w in ("depth_head.out.weight", "depth_head.out.weight_X",
              "blocks.0.extra"):
        assert w in str(want.value) and w in str(got.value), w


def test_omnimae_trunk_spelling_loads_what_jax_converts(tmp_path):
    """A ViT-B trunk with its patch conv as ``patch_embed.proj.*`` (what
    ``infer_omnimae_variant`` already recognised) and a ``trunk.``
    prefix."""
    model = tomni.omnimae_vit("vit_base").init_weights(
        torch.Generator().manual_seed(0))
    sd = {"trunk." + k.replace("patch_embed.proj.1.", "patch_embed.proj."):
          v for k, v in model.state_dict().items()}
    torch.save(sd, tmp_path / "omni.pth")
    assert callable(tenc.build_mpm_extractor(str(tmp_path / "omni.pth"),
                                             device="cpu"))
    trunk = tenc.load_mpm_trunk(sd, device="cpu")
    want = convert.omnimae_state_dict(jomni.convert_omnimae_state_dict(
        sd, depth=12), 12)
    got = trunk.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("tower", ["t5", "clip"])
def test_tower_from_checkpoint_is_built_on_meta(tmp_path, monkeypatch,
                                                tower):
    """A tower from a bf16 checkpoint is built on the meta device and
    given the checkpoint's tensors, cast to bf16: no float32 copy of the
    tower is made on the host."""
    made_on = []
    if tower == "t5":
        cfg = T5Config(vocab=64, dim=32, dim_attn=32, dim_ffn=48, num_heads=4,
                       num_layers=2, num_buckets=8, text_len=9)
        base = tenc.WanT5Encoder
        name, prefix = "WanT5Encoder", ""
    else:
        cfg = CLIPVisionConfig(image_size=28, patch_size=14, dim=32,
                               num_heads=2, num_layers=3)
        base = tenc.ClipVisionTower
        name, prefix = "ClipVisionTower", "visual."

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made_on.append(next(self.parameters()).device.type)

    sd = base(cfg).init_weights(torch.Generator().manual_seed(0)).state_dict()
    sd = {prefix + k: v.bfloat16() for k, v in sd.items()}
    monkeypatch.setattr(tenc, name, Recorded)
    if tower == "t5":
        tenc.build_text_encoder(sd, lambda p: (np.ones((1, 9), np.int64),
                                               np.ones((1, 9))), cfg,
                                torch.bfloat16, "cpu")
    else:
        tenc.build_clip_encoder(sd, cfg, torch.bfloat16, "cpu")
    assert made_on and set(made_on) == {"meta"}


# --------------------------------------------------------- safetensors

def test_safetensors_reader_writer_round_trip(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"bf16": torch.randn(3, 5, generator=g).bfloat16(),
               "f16": torch.randn(7, generator=g).half(),
               "f32": torch.randn(2, 3, 4, generator=g),
               "i64": torch.arange(5), "i32": torch.arange(3,
                                                           dtype=torch.int32),
               "scalar": torch.tensor(2.0), "empty": torch.zeros(0, 4)}
    ours = str(tmp_path / "ours.safetensors")
    safetensors_io.save_file(tensors, ours)
    theirs = str(tmp_path / "theirs.safetensors")
    st.save_file(tensors, theirs, metadata={"format": "pt"})
    for got in (st.load_file(ours), safetensors_io.load_file(ours),
                safetensors_io.load_file(theirs)):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
