"""The port's device mesh and Ulysses attention against the JAX package's
(``more4d_tpu/parallel``), on the CPU: the mesh rules with tolerance 0,
and the collectives on 2 and 4 gloo ranks spawned by ``_torch_dist``.

- ``MeshConfig.resolve``, ``parse_mesh_spec`` (its errors too) and the
  FSDP rule: the same answers as JAX's for the same shapes, the rule read
  on every parameter shape of the tiny, 1.3B and 14B DiTs.
- ``ulysses_attention`` (with and without ``kv_lens``, and its gradient)
  on 2 and 4 ranks, each holding L/S tokens, against JAX's single-device
  ``xla_attention`` and its VJP: 1e-5 (fp32).
- The tiny 4D DiT's forward with a seq mesh of 2 installed and its
  parameters FSDP-sharded over the other 2 of 4 ranks, on 27 tokens (odd,
  so the padding to a multiple of S runs), against the JAX ``WanDiT`` on
  one device, as ``tests/test_parallel.py`` holds JAX against itself:
  1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from more4d_tpu.config import dit_tiny as jax_dit_tiny
from more4d_tpu.kernels.flash_attention import xla_attention
from more4d_tpu.models import WanDiT as JaxWanDiT
from more4d_tpu.parallel import MeshConfig as JaxMeshConfig
from more4d_tpu.parallel import create_mesh as jax_create_mesh
from more4d_tpu.parallel import data_sharding as jax_data_sharding
from more4d_tpu.parallel import parse_mesh_spec as jax_parse_mesh_spec
from more4d_tpu.parallel.mesh import _fsdp_spec as jax_fsdp_spec
from more4d_tpu_torch.config import dit_1_3b, dit_14b, dit_tiny
from more4d_tpu_torch.convert import dit_state_dict
from more4d_tpu_torch.models import WanDiT
from more4d_tpu_torch.parallel import MeshConfig, parse_mesh_spec
from more4d_tpu_torch.parallel.mesh import fsdp_sharding, fsdp_spec


@pytest.mark.parametrize("cfg,n", [
    (dict(), 8), (dict(data=2), 8), (dict(data=2, fsdp=-1), 8),
    (dict(seq=2, fsdp=-1), 8), (dict(dcn=2, data=2, fsdp=2), 8),
    (dict(data=-1, fsdp=1), 4), (dict(fsdp=-1), 1), (dict(data=2), 1),
    (dict(data=2, fsdp=4), 1), (dict(data=3, fsdp=-1), 8)])
def test_mesh_config_resolve_matches_jax(cfg, n):
    try:
        want = jax_dataclass_tuple(JaxMeshConfig(**cfg).resolve(n))
    except AssertionError as e:
        with pytest.raises(AssertionError) as got:
            MeshConfig(**cfg).resolve(n)
        assert str(got.value) == str(e).replace("JaxMeshConfig",
                                                "MeshConfig")
        return
    got = MeshConfig(**cfg).resolve(n)
    assert (got.dcn, got.data, got.fsdp, got.seq) == want


def jax_dataclass_tuple(c):
    return (c.dcn, c.data, c.fsdp, c.seq)


@pytest.mark.parametrize("spec", [
    None, "", "data=2,fsdp=4", "data=2,fsdp=-1", "seq=2,fsdp=-1",
    "dcn=2,data=1,fsdp=4", " fsdp = 2", "tensor=2", "data=2,pipe=3"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    got = parse_mesh_spec(spec)
    if want is None:
        assert got is None
    else:
        assert jax_dataclass_tuple(got) == jax_dataclass_tuple(want)


def _dit_shapes():
    shapes = {(256, 1024), (8,), (333, 777), (4, 6, 8), (64, 64, 3),
              (1024,), (2, 1024)}
    with torch.device("meta"):
        for cfg in (dit_tiny(), dit_1_3b(motion_guidance=True, in_dim=64,
                                         model_type="i2v"),
                    dit_14b(True, in_dim=64, model_type="i2v",
                            num_layers=1)):
            shapes |= {tuple(p.shape) for p in WanDiT(cfg).parameters()}
    return sorted(shapes)


@pytest.mark.parametrize("fsdp,min_size", [(1, 2 ** 16), (2, 2 ** 16),
                                           (4, 1024), (8, 2 ** 16),
                                           (3, 256)])
def test_fsdp_rule_matches_jax(fsdp, min_size):
    """The spec of every shape, JAX's ``_fsdp_spec`` and the port's
    ``fsdp_spec``, and ``fsdp_sharding`` on a dict of tensors."""
    shapes = _dit_shapes()
    for shape in shapes:
        assert fsdp_spec(shape, fsdp, min_size) == \
            tuple(jax_fsdp_spec(shape, fsdp, min_size)), shape

    class Mesh:                       # fsdp_sharding reads the axis sizes
        mesh_dim_names = ("dcn", "data", "fsdp", "seq")
        mesh = torch.zeros(1, 1, fsdp, 1)

    got = fsdp_sharding({str(s): torch.empty(s, device="meta")
                         for s in shapes}, Mesh(), min_size)
    assert got == {str(s): tuple(jax_fsdp_spec(s, fsdp, min_size))
                   for s in shapes}


def _jax_rows(jmesh):
    """{mesh coordinate: rows of arange(8)} of JAX's data_sharding."""
    xs = jax.device_put(jnp.arange(8.0).reshape(8, 1),
                        jax_data_sharding(jmesh, ndim=2))
    out = {}
    for shard in xs.addressable_shards:
        pos = np.argwhere(jmesh.devices == shard.device)[0]
        out[tuple(pos)] = np.asarray(shard.data)[:, 0]
    return out


def test_mesh_layout_matches_jax(tmp_path):
    """dcn=2 x fsdp=2 on 4 ranks: the batch splits over dcn, the same rows
    on the fsdp pair, as JAX's data_sharding on dcn=2 x fsdp=2 x data=1
    lays out its shards; parameters shard over fsdp only. On data=2 x
    seq=2 the two seq ranks of a data shard take its rows, as in JAX
    (the trainer installs no Ulysses mesh: a seq axis replicates)."""
    ranks = td.spawn(td.layout_worker, 4, tmp_path)
    jmesh = jax_create_mesh(JaxMeshConfig(dcn=2, data=1, fsdp=2, seq=1),
                            jax.devices()[:4])
    want = _jax_rows(jmesh)
    want_seq = _jax_rows(jax_create_mesh(
        JaxMeshConfig(data=2, fsdp=1, seq=2), jax.devices()[:4]))
    for got in ranks:
        coord = tuple(got["coord"])
        np.testing.assert_array_equal(got["rows"], want[coord])
        # the seq ranks of one data shard take the same rows
        np.testing.assert_array_equal(got["seq_rows"],
                                      want_seq[tuple(got["seq_coord"])])
        d, f = coord[0], coord[2]
        assert sorted(got["replicate"]) == [f, 2 + f]
        assert sorted(got["shard"]) == [2 * d, 2 * d + 1]
        for name, (shape, placements) in got["params"].items():
            spec = tuple(jax_fsdp_spec(shape, 2, 2 ** 16))
            dim = spec.index("fsdp") if spec else 0
            assert placements == f"(Replicate(), Shard(dim={dim}))", name


def _qkv(seed, b, l, h, d):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, l, h, d).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("world,kv_lens", [
    (2, None), (2, [10, 32]), (4, None), (4, [19, 7])],
    ids=["2", "2-kv_lens", "4", "4-kv_lens"])
def test_ulysses_matches_jax_attention(tmp_path, world, kv_lens):
    b, l, h, d = 2, 32, 4, 16
    q, k, v, dout = _qkv(world, b, l, h, d)
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int32)
    ranks = td.spawn(td.ulysses_worker, world, tmp_path, q, k, v, lens,
                     dout)

    def ref(q, k, v):
        return xla_attention(q, k, v, kv_lens=None if lens is None
                             else jnp.asarray(lens))

    out, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = dict(zip(("dq", "dk", "dv"), vjp(jnp.asarray(dout))))
    got = {n: np.concatenate([r[n] for r in ranks], axis=1)
           for n in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], np.asarray(out), atol=1e-5,
                               rtol=0)
    for n, g in grads.items():
        np.testing.assert_allclose(got[n], np.asarray(g), atol=1e-5,
                                   rtol=0, err_msg=n)


def test_ulysses_refuses_heads_that_do_not_split(tmp_path):
    """3 heads on a seq axis of 2 raise, as the JAX docstring requires
    H % S == 0."""
    errors = td.spawn(td.ulysses_heads_worker, 2, tmp_path)
    assert all(e and "3 heads" in e for e in errors)


def _tiny_4d_dit_case():
    """The tiny 4D DiT (MPM FiLM, i2v) on 27 tokens: (config keywords,
    the port's state dict, the inputs, JAX's WanDiT output on one
    device)."""
    kw = dict(num_heads=2, motion_guidance=True)
    jcfg = jax_dit_tiny(dtype=jnp.float32, attention_backend="xla", **kw)
    rs = np.random.RandomState(2)
    x = rs.randn(1, 3, 6, 6, 16).astype(np.float32)
    inputs = dict(
        x=x, t=np.asarray([400.0], np.float32),
        context=rs.randn(1, 7, jcfg.text_dim).astype(np.float32),
        y=rs.randn(1, 3, 6, 6, jcfg.in_dim - 16).astype(np.float32),
        clip_fea=rs.randn(1, jcfg.clip_tokens,
                          jcfg.clip_dim).astype(np.float32),
        mpm_features=rs.randn(1, 196,
                              jcfg.motion_feature_dim).astype(np.float32))
    model = JaxWanDiT(jcfg)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), j["x"],
                            j["t"], j["context"], y=j["y"],
                            clip_fea=j["clip_fea"],
                            mpm_features=j["mpm_features"])
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    prs = np.random.RandomState(3)
    params = jax.tree_util.tree_unflatten(
        tree, [np.asarray(prs.normal(0, 0.05, l.shape), np.float32)
               for l in leaves])
    want = np.asarray(model.apply(params, j.pop("x"), j.pop("t"),
                                  j.pop("context"), **j))
    state = {k: v.numpy() for k, v in dit_state_dict(
        params, dit_tiny(dtype=torch.float32, **kw)).items()}
    return kw, state, inputs, want


def test_sequence_parallel_dit_matches_jax(tmp_path):
    """The tiny 4D DiT at seq=2 x fsdp=2 against JAX's WanDiT on one
    device, the same weights."""
    kw, state, inputs, want = _tiny_4d_dit_case()
    ranks = td.spawn(td.seq_dit_worker, 4, tmp_path, kw, state, inputs, 2)
    for got in ranks:
        assert got.shape == want.shape == (1, 3, 6, 6, 16)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sequence_parallel_dit_takes_seq_rank_0s_inputs(tmp_path):
    """At seq=2 the rank off seq rank 0 is handed other inputs (each
    array + 1): both ranks still give JAX's output on rank 0's inputs, as
    the Ulysses sequence is cut from seq rank 0's embedded tokens, and
    the cross-attention reads its context."""
    kw, state, inputs, want = _tiny_4d_dit_case()
    ranks = td.spawn(td.seq_dit_worker, 2, tmp_path, kw, state, inputs, 2,
                     True)
    for got in ranks:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
