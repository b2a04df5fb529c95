"""The port's Wan VAE (streamed encode/decode) and trajectory adaptors
against the JAX package, with the same converted weights, at tiny fp32
configs on the CPU.

Tolerance: atol 1e-4 on latents and frames of magnitude ~1 — both sides
run fp32 convolutions whose sums are ordered differently (XLA vs oneDNN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from more4d_tpu.config import VAEConfig as JaxVAEConfig
from more4d_tpu.convert.vae_torch import convert_vae_state_dict
from more4d_tpu.models.adaptors import (VAEDecoderAdaptor as JaxDec,
                                        VAEEncoderAdaptor as JaxEnc,
                                        convert_adaptor_state_dict)
from more4d_tpu.models.vae_streaming import (decode_streamed as
                                             jax_decode_streamed,
                                             encode_streamed as
                                             jax_encode_streamed)
from more4d_tpu.models.wan_vae import WanVAE as JaxWanVAE
from more4d_tpu_torch.config import VAEConfig
from more4d_tpu_torch.convert import adaptor_state_dict, vae_state_dict
from more4d_tpu_torch.models.adaptors import (VAEDecoderAdaptor,
                                              VAEEncoderAdaptor)
from more4d_tpu_torch.models.vae_streaming import (decode_streamed,
                                                   encode_streamed)
from more4d_tpu_torch.models.wan_vae import WanVAE

ATOL = 1e-4
T, H, W = 9, 16, 16
CFG = dict(dim=4, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1,
           temporal_downsample=(False, True, True))


def _randomized(params, seed):
    leaves, td = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_unflatten(
        td, [np.asarray(rs.normal(0, 0.3, l.shape), np.float32)
             for l in leaves])


@pytest.fixture(scope="module")
def vae_pair():
    jvae = JaxWanVAE(JaxVAEConfig(**CFG))
    params = _randomized(jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                        jnp.zeros((1, T, H, W, 3))), 1)
    tvae = WanVAE(VAEConfig(**CFG))
    tvae.load_state_dict(vae_state_dict(params, tvae.cfg), strict=True)
    return jvae, params, tvae


@pytest.mark.parametrize("per_step", [1, 2])
def test_streamed_encode_matches_jax(vae_pair, per_step):
    jvae, params, tvae = vae_pair
    x = np.random.RandomState(2).uniform(-1, 1, (2, T, H, W, 3)).astype(
        np.float32)
    mu_j, lv_j = jax_encode_streamed(jvae, params, x,
                                     latents_per_step=per_step)
    with torch.no_grad():
        mu_t, lv_t = encode_streamed(tvae, torch.from_numpy(x),
                                     latents_per_step=per_step)
    assert mu_t.shape == mu_j.shape == (2, 3, H // 8, W // 8, 4)
    assert np.abs(mu_t.numpy() - np.asarray(mu_j)).max() < ATOL
    assert np.abs(lv_t.numpy() - np.asarray(lv_j)).max() < ATOL


def test_static_hint_encode_matches_jax(vae_pair):
    """A repeated-frame video: the JAX side skips converged chunks, the
    port computes them all; the numbers agree."""
    jvae, params, tvae = vae_pair
    frame = np.random.RandomState(3).uniform(-1, 1, (1, 1, H, W, 3))
    x = np.repeat(frame, T, axis=1).astype(np.float32)
    mu_j, _ = jax_encode_streamed(jvae, params, x, static_hint=True)
    with torch.no_grad():
        mu_t, _ = encode_streamed(tvae, torch.from_numpy(x),
                                  static_hint=True)
    assert np.abs(mu_t.numpy() - np.asarray(mu_j)).max() < ATOL


@pytest.mark.parametrize("per_step", [1, 2])
def test_streamed_decode_matches_jax(vae_pair, per_step):
    jvae, params, tvae = vae_pair
    z = np.random.RandomState(4).randn(2, 3, H // 8, W // 8, 4).astype(
        np.float32)
    want = np.asarray(jax_decode_streamed(jvae, params, z,
                                          latents_per_step=per_step))
    with torch.no_grad():
        got = decode_streamed(tvae, torch.from_numpy(z),
                              latents_per_step=per_step).numpy()
    assert got.shape == want.shape == (2, T, H, W, 3)
    assert np.abs(got - want).max() < ATOL


def test_vae_keys_are_the_released_layout(vae_pair):
    """The JAX package's Wan2.1_VAE.pth converter reads the port's state
    dict back into the JAX params it came from."""
    jvae, params, tvae = vae_pair
    back = convert_vae_state_dict(tvae.state_dict(), tvae.cfg)
    a = jax.tree_util.tree_leaves_with_path(back["params"])
    b = dict(jax.tree_util.tree_leaves_with_path(params["params"]))
    assert len(a) == len(b)
    for path, leaf in a:
        np.testing.assert_array_equal(leaf, np.asarray(b[path]))


@pytest.mark.parametrize("decoder", [True, False], ids=["decoder",
                                                         "encoder"])
def test_adaptor_matches_jax(decoder):
    jmod = JaxDec(ch=8) if decoder else JaxEnc(ch=8)
    x = np.random.RandomState(5).uniform(-1, 1, (1, 3, 8, 8, 3)).astype(
        np.float32)
    params = _randomized(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x),
                         6)
    tmod = VAEDecoderAdaptor(ch=8) if decoder else VAEEncoderAdaptor(ch=8)
    sd = adaptor_state_dict(params, decoder=decoder)
    tmod.load_state_dict(sd, strict=True)
    want = np.asarray(jmod.apply(params, x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() < ATOL
    # the JAX package's torch-checkpoint reader takes the port's keys
    back = convert_adaptor_state_dict(tmod.state_dict(), decoder=decoder)
    for path, leaf in jax.tree_util.tree_leaves_with_path(back):
        ref = dict(jax.tree_util.tree_leaves_with_path(params))[path]
        np.testing.assert_array_equal(leaf, np.asarray(ref))
