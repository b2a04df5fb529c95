"""The port's LoRA (``train/lora.py``, ``convert/lora_torch.py``) against
the JAX package's on the CPU (tiny i2v DiT, fp32).

A kohya LoRA on the self and cross attentions (the image keys too) and the
FFN goes through both packages' converters and merges at weight 0.55 into
the same base weights: within 1e-6 max-abs (the rank-r products are
summed in different orders). ``export_kohya_lora`` undoes
``convert_kohya_lora`` exactly, and matches the JAX export.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.convert import lora_torch as jlt
from more4d_tpu.models.wan_dit import WanDiT as JaxWanDiT
from more4d_tpu.train import lora as jlora
from more4d_tpu_torch import convert
from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.convert import lora_torch as tlt
from more4d_tpu_torch.train import lora as tlora

CFG = dict(motion_guidance=False, in_dim=36, model_type="i2v")
MODULES = {"self_attn_q": (128, 128), "self_attn_o": (128, 128),
           "cross_attn_k_img": (128, 128), "cross_attn_v": (128, 128),
           "ffn_0": (256, 128), "ffn_2": (128, 256)}


@pytest.fixture(scope="module")
def base():
    """JAX params of the tiny DiT (non-zero everywhere) and the port's
    state dict of the same weights."""
    jcfg = jax_dit_tiny(dtype=jnp.float32, **CFG)
    rs = np.random.RandomState(0)
    x = jnp.zeros((1, 1, 4, 4, 16))
    shapes = jax.eval_shape(
        JaxWanDiT(jcfg).init, jax.random.PRNGKey(0), x, jnp.zeros((1,)),
        jnp.zeros((1, jcfg.text_len, jcfg.text_dim)),
        y=jnp.zeros((1, 1, 4, 4, 20)),
        clip_fea=jnp.zeros((1, jcfg.clip_tokens, jcfg.clip_dim)))
    leaves, td = jax.tree_util.tree_flatten(shapes)
    params = jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, 0.05, l.shape), np.float32)
             for l in leaves])
    return jcfg, params, convert.dit_state_dict(params, dit_tiny(**CFG))


def kohya(seed=7, rank=3):
    """A kohya LoRA on both blocks; each module has its own alpha (the
    converters keep the last one read)."""
    rs = np.random.RandomState(seed)
    sd = {}
    for b in range(2):
        for j, (mod, (o, i)) in enumerate(MODULES.items()):
            key = f"lora_unet_blocks_{b}_{mod}"
            sd[key + ".lora_down.weight"] = torch.from_numpy(
                rs.randn(rank, i).astype(np.float32) * 0.1)
            sd[key + ".lora_up.weight"] = torch.from_numpy(
                rs.randn(o, rank).astype(np.float32) * 0.1)
            sd[key + ".alpha"] = torch.tensor(1.0 + j)
    return sd


@pytest.mark.parametrize("multiplier", [0.55, 1.0])
def test_kohya_merge_matches_jax_apply_lora(base, multiplier):
    jcfg, params, sd = base
    k = kohya()
    jl = jlt.convert_kohya_lora(k, jcfg)
    want = convert.dit_state_dict(
        jlora.apply_lora(params, jl, multiplier=multiplier), dit_tiny(**CFG))
    lora = tlt.convert_kohya_lora(k)
    assert lora["rank"] == jl["rank"] == 3
    assert lora["alpha"] == jl["alpha"] == float(len(MODULES))
    got = tlora.apply_lora(sd, lora, multiplier=multiplier)
    assert sorted(got) == sorted(want)
    worst = max((got[n] - want[n]).abs().max().item() for n in want)
    assert worst <= 1e-6, worst
    changed = [n for n in sd if not torch.equal(got[n], sd[n])]
    assert sorted(changed) == sorted(lora["factors"])
    assert len(changed) == 2 * len(MODULES)


def test_merge_keeps_bf16_weights_bf16_and_merges_in_fp32(base):
    _, _, sd = base
    lora = tlt.convert_kohya_lora(kohya())
    name = "blocks.1.ffn.0.weight"
    lora["factors"] = {name: lora["factors"][name]}
    got = tlora.apply_lora({name: sd[name].bfloat16()}, lora, 0.55)[name]
    f = lora["factors"][name]
    want = (sd[name].bfloat16().float()
            + 0.55 * lora["alpha"] / lora["rank"] * f["up"] @ f["down"])
    assert got.dtype == torch.bfloat16 and torch.equal(got,
                                                       want.bfloat16())


def test_export_inverts_convert_and_matches_jax_export(base):
    jcfg, _, _ = base
    k = kohya(seed=3)
    lora = tlt.convert_kohya_lora(k)
    back = tlt.convert_kohya_lora(tlt.export_kohya_lora(lora))
    assert (back["rank"], back["alpha"]) == (lora["rank"], lora["alpha"])
    assert sorted(back["factors"]) == sorted(lora["factors"])
    for n, f in lora["factors"].items():
        assert all(torch.equal(back["factors"][n][p], f[p])
                   for p in ("down", "up")), n
    # the same LoRA from the JAX converter, carried across, exports the
    # JAX export's tensors
    jl = jlt.convert_kohya_lora(k, jcfg)
    want = jlt.export_kohya_lora(jl)
    got = tlt.export_kohya_lora(convert.lora_factors(jl))
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(v), key)


def test_create_lora_targets_and_shapes_match_jax(base):
    jcfg, params, sd = base
    jl = jlora.create_lora(params, jax.random.PRNGKey(0), rank=4, alpha=2.0,
                           skip_name="k_img")
    got = tlora.create_lora(sd, torch.Generator().manual_seed(0), rank=4,
                            alpha=2.0, skip_name="k_img")
    want = convert.lora_factors(jl)
    assert sorted(got["factors"]) == sorted(want["factors"])
    assert not any("k_img" in n for n in got["factors"])
    for n, f in got["factors"].items():
        assert f["down"].shape == want["factors"][n]["down"].shape, n
        assert f["up"].shape == want["factors"][n]["up"].shape, n
        assert not f["up"].any()
        bound = (6.0 / f["down"].shape[1]) ** 0.5
        assert f["down"].abs().max() <= bound
    assert tlora.lora_param_count(got) == jlora.lora_param_count(jl)
    # a zero up factor merges to the identity
    merged = tlora.apply_lora(sd, got, 1.0)
    assert all(torch.equal(merged[n], sd[n]) for n in sd)


def test_save_and_load_vism_lora(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    lora = tlt.convert_kohya_lora(kohya(seed=5))
    path = str(tmp_path / "vism.safetensors")
    tlt.save_kohya_lora(path, lora)
    for loaded in (tlt.load_vism_lora(path),
                   tlt.convert_kohya_lora(st.load_file(path))):
        assert (loaded["rank"], loaded["alpha"]) == (lora["rank"],
                                                     lora["alpha"])
        for n, f in lora["factors"].items():
            assert torch.equal(loaded["factors"][n]["down"], f["down"])
            assert torch.equal(loaded["factors"][n]["up"], f["up"])
    torch.save(kohya(seed=5), tmp_path / "vism.pth")
    assert sorted(tlt.load_vism_lora(str(tmp_path / "vism.pth"))[
        "factors"]) == sorted(lora["factors"])
