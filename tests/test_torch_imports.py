"""Guards for the PyTorch port: it never imports JAX or the JAX package,
and on a host without a card its entry points and kernel wrappers refuse a
CUDA request instead of quietly computing on the CPU."""

import ast
import importlib
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "more4d_tpu")


def _port_files():
    files = sorted((ROOT / "more4d_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [f"{p.relative_to(ROOT)}: import {m}" for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_cuda_request_raises_without_a_card(monkeypatch):
    from more4d_tpu_torch import resolve_device
    from more4d_tpu_torch.infer import build_two_stage_models
    from more4d_tpu_torch.kernels import _build
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        # the default device is the card
        build_two_stage_models((lambda prompts: None, None, None))
    assert resolve_device("cpu").type == "cpu"
    # the wrappers check their tensors before anything is built or launched
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    rec = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match="CUDA"):
        splat_cuda(rec, rec, rec, rec, torch.zeros(1, 1, 4, 3),
                   torch.zeros(1, 1, dtype=torch.int32), 1)
    assert not _build._loaded


def test_scan_covers_the_scripts_subpackage():
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    for script in ("infer", "infer_vae", "check_wan", "check_unidepth",
                   "train_vism", "train_vae", "train_straag"):
        assert f"more4d_tpu_torch/scripts/{script}.py" in names


@pytest.mark.parametrize("module", [
    "data/prefetch", "data/vism", "train/lora_streamed", "train/train_vism",
    "train/train_vae", "train/optim", "train/lora", "convert/params",
    "parallel/offload", "data/buckets", "data/masks", "data/camera_cond",
    "nn/remat", "train/train_straag", "train/harness",
    "scripts/train_straag"])
def test_scan_covers_the_training_modules(module):
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert f"more4d_tpu_torch/{module}.py" in names
    mod = importlib.import_module("more4d_tpu_torch." + module.replace(
        "/", "."))
    assert not [m for m in _imported_modules(pathlib.Path(mod.__file__))
                if m.split(".")[0] in FORBIDDEN]


CLI_ARGV = {
    "infer": ["--image", "x.png", "--prompt", "p", "--control_ckpt", "c",
              "--inp_ckpt", "i", "--vae_ckpt", "v", "--decoder_adaptor",
              "d"],
    "infer_vae": ["--video_list", "l", "--vae_ckpt", "v",
                  "--encoder_adaptor", "e", "--decoder_adaptor", "d"],
    "train_vism": ["--data_dir", "d", "--pretrained_ckpt", "p",
                   "--vae_ckpt", "v"],
    "train_vae": ["--video_list", "l", "--vae_ckpt", "v"],
}


@pytest.mark.parametrize("entry", ["infer.main", "infer.load_models",
                                   "infer_vae.main", "train_vism.main",
                                   "train_vae.main"])
def test_cli_entry_points_refuse_cuda_without_a_card(monkeypatch, entry):
    """Before any file is read: the paths above do not exist."""
    script, fn = entry.split(".")
    mod = importlib.import_module(f"more4d_tpu_torch.scripts.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = CLI_ARGV[script]
    with pytest.raises(RuntimeError, match="CUDA"):
        if fn == "main":
            mod.main(argv)
        else:
            mod.load_models(mod.build_parser().parse_args(argv))


@pytest.mark.parametrize("script", ["train_vism", "train_vae"])
def test_training_loops_refuse_cuda_without_a_card(monkeypatch, script):
    """``run_training`` runs on the card unless asked for the CPU."""
    import types

    mod = importlib.import_module(f"more4d_tpu_torch.scripts.{script}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = mod.build_parser().parse_args(CLI_ARGV[script])
    with pytest.raises(RuntimeError, match="CUDA"):
        if script == "train_vism":
            mod.run_training(torch.nn.Linear(1, 1), None, None, iter(()),
                             args)
        else:
            mod.run_training(types.SimpleNamespace(), None, None, iter(()),
                             args)
