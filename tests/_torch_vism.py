"""Shared set-up of the ViSM trainer parity tests: a tiny InP DiT (i2v, no
motion guidance) and a tiny umT5 in both packages from the same numpy
weights, LoRAs carried across with ``convert.lora_factors``, and the JAX
step's own timestep and noise draws for the port's step."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from more4d_tpu.config import T5Config as JaxT5Config
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.models.t5 import WanT5Encoder as JaxT5
from more4d_tpu.train.lora import create_lora as jax_create_lora
from more4d_tpu.train.sampler import (StratifiedTimestepSampler,
                                      timestep_density_u)
from more4d_tpu_torch.config import dit_tiny, t5_tiny
from more4d_tpu_torch.convert import (dit_state_dict, lora_factors,
                                      t5_state_dict)
from more4d_tpu_torch.models import WanDiT, WanT5Encoder

DIT = dict(in_dim=24, out_dim=4, dim=32, ffn_dim=64, num_heads=2,
           num_layers=3, text_dim=16, clip_dim=16, text_len=8, clip_tokens=9,
           motion_guidance=False, model_type="i2v")
T5 = dict(vocab=32, dim=16, dim_attn=16, dim_ffn=32, num_heads=2,
          num_layers=2, text_len=8)
B, LT, LH, LW = 1, 3, 4, 4


def batch(seed=0, te=False):
    """A numpy batch: latents, y (4 mask + 16 video channels), CLIP
    features, and context or (with ``te``) ids with a padded tail."""
    rs = np.random.RandomState(seed)
    out = {"latents": rs.randn(B, LT, LH, LW, 4).astype(np.float32),
           "y": rs.randn(B, LT, LH, LW, 20).astype(np.float32),
           "clip_fea": rs.randn(B, 9, 16).astype(np.float32)}
    if te:
        out["input_ids"] = rs.randint(1, 32, (B, 8)).astype(np.int32)
        mask = np.ones((B, 8), np.float32)
        mask[:, 5:] = 0.0
        out["attention_mask"] = mask
    else:
        out["context"] = rs.randn(B, 8, 16).astype(np.float32)
    return out


def torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


def _random_tree(tree, seed, std=0.04):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td, [jnp.asarray(rs.normal(0, std, l.shape), jnp.float32)
             for l in leaves])


def jax_dit(seed=1, **over):
    """(JAX model, params): random normal params, not the zero head and
    gates of a fresh model (they would give the factors no gradient)."""
    cfg = jax_dit_tiny(dtype=jnp.float32, **{**DIT, **over})
    model = JaxWanDiT(cfg)
    grid = (B, LT, LH, LW)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros(grid + (cfg.out_dim,)),
        jnp.zeros((B,)), jnp.zeros((B, 8, cfg.text_dim)),
        y=jnp.zeros(grid + (cfg.in_dim - cfg.out_dim,)),
        clip_fea=jnp.zeros((B, 9, cfg.clip_dim)))
    return model, _random_tree(shapes, seed)


def port_dit(params, **over):
    cfg = dit_tiny(dtype=torch.float32, **{**DIT, **over})
    dit = WanDiT(cfg)
    dit.load_state_dict(dit_state_dict(params, cfg), strict=True)
    return dit.requires_grad_(False)


def jax_t5(seed=2):
    cfg = JaxT5Config(dtype=jnp.float32, **T5)
    model = JaxT5(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    return model, _random_tree(shapes, seed, std=0.2)


def port_t5(params):
    cfg = t5_tiny(dtype=torch.float32, **T5)
    t5 = WanT5Encoder(cfg)
    t5.load_state_dict(t5_state_dict(params, cfg), strict=True)
    return t5.requires_grad_(False)


def jax_lora(params, seed=3, rank=2, alpha=2.0, **kw):
    """``create_lora``'s tree with its up factors drawn too, so every
    factor gets a gradient and a dropped projection would move the
    loss."""
    lora = jax_create_lora(params, jax.random.PRNGKey(seed), rank=rank,
                           alpha=alpha, **kw)
    rs = np.random.RandomState(seed)
    lora["factors"] = {
        k: {"down": jnp.asarray(f["down"]),
            "up": jnp.asarray(rs.randn(*np.shape(f["up"])) * 0.05,
                              jnp.float32)}
        for k, f in lora["factors"].items()}
    return lora


def port_lora(lora, t5=False):
    out = lora_factors(lora, t5=t5)
    for f in out["factors"].values():
        for t in f.values():
            t.requires_grad_(True)
    return out


def jax_draws(key, shape, uniform=True, scheme="none"):
    """make_vism_train_step's own (idx, noise) for one step."""
    rng_t, rng_n = jax.random.split(key)
    if uniform:
        idx = StratifiedTimestepSampler(1000)(rng_t, shape[0])
    else:
        u = timestep_density_u(rng_t, scheme, shape[0])
        idx = jnp.clip((u * 1000).astype(jnp.int32), 0, 999)
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return (torch.from_numpy(np.asarray(idx).astype(np.int64)),
            torch.from_numpy(np.array(noise)))


def assert_factors_close(port, jax_lora_tree, t5=False, rtol=1e-5,
                         atol=1e-6):
    want = lora_factors(jax_lora_tree, t5=t5)["factors"]
    assert set(port["factors"]) == set(want)
    for name, f in want.items():
        for k in ("down", "up"):
            np.testing.assert_allclose(
                port["factors"][name][k].detach().numpy(), f[k].numpy(),
                rtol=rtol, atol=atol, err_msg=f"{name} {k}")
