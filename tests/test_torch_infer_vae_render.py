"""``infer_vae --save_videos``'s side-by-side renders in the port
(``more4d_tpu_torch/scripts/infer_vae.py:build_render_fn``) against the
JAX CLI's ``build_render_fn``, on the CPU: the frames each writes are
captured where it would save them.

Tolerances: the z-buffer projection (``--render_type project``) to 1e-6
(both take the mean colour over a pixel's nearest points in float64 and
round once); the tile splat (``3dgs``, in ``both``) to 2e-5, as
``tests/test_torch_gs_splat.py`` holds K4's plain version to the Pallas
kernel.
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import more4d_tpu.utils.artifacts as jax_artifacts
import more4d_tpu_torch.utils.artifacts as port_artifacts
from more4d_tpu_torch.scripts import infer_vae

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, H, W = 3, 64, 64


def _jax_infer_vae():
    spec = importlib.util.spec_from_file_location(
        "jax_cli_infer_vae", ROOT / "scripts" / "infer_vae.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _captured(monkeypatch, module):
    saved = {}

    def save(path, videos, fps=8):
        saved[pathlib.Path(path).name] = np.asarray(
            videos.cpu() if isinstance(videos, torch.Tensor) else videos)

    monkeypatch.setattr(module, "save_videos_grid", save)
    return saved


def _flows():
    rs = np.random.RandomState(0)
    flow = (0.3 * rs.randn(T, H, W, 3)).astype(np.float32)
    recon = flow + (0.05 * rs.randn(T, H, W, 3)).astype(np.float32)
    return flow, recon


@pytest.mark.parametrize("render_type", ["project", "both"])
def test_render_fn_matches_jax(monkeypatch, tmp_path, render_type):
    args = types.SimpleNamespace(height=H, width=W, output_dir=str(tmp_path),
                                 render_type=render_type, gs_scale=1e-3)
    want = _captured(monkeypatch, jax_artifacts)
    got = _captured(monkeypatch, port_artifacts)
    flow, recon = _flows()
    _jax_infer_vae().build_render_fn(args)("s0", flow, recon)
    infer_vae.build_render_fn(args, "cpu")("s0", flow, recon)
    names = {"project": ["s0_roundtrip.mp4"],
             "both": ["s0_roundtrip.mp4", "s0_roundtrip_gs.mp4"]}
    assert sorted(got) == sorted(want) == names[render_type]
    proj_got, proj_want = got["s0_roundtrip.mp4"], want["s0_roundtrip.mp4"]
    assert proj_got.shape == proj_want.shape == (1, T, H // 2, W, 3)
    # the hole pixels (all-zero colours) exactly, the colours to 1e-6
    np.testing.assert_array_equal(proj_got.sum(-1) == 0,
                                  proj_want.sum(-1) == 0)
    np.testing.assert_allclose(proj_got, proj_want, rtol=0, atol=1e-6)
    assert 0 < (proj_want.sum(-1) == 0).mean() < 1
    if render_type == "both":
        np.testing.assert_allclose(got["s0_roundtrip_gs.mp4"],
                                   want["s0_roundtrip_gs.mp4"], rtol=0,
                                   atol=2e-5)
