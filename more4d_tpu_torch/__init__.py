"""more4d_tpu_torch — the PyTorch/CUDA port of ``more4d_tpu``.

Single image -> 4D videos on an NVIDIA Hopper card. The module layout
mirrors the JAX package, so each module's counterpart has the same path:

- ``more4d_tpu_torch.models``    — Wan DiT (3D/4D), causal video VAE, VAE
  trajectory adaptors.
- ``more4d_tpu_torch.kernels``   — hand-written Hopper kernels (flash
  attention forward, tile splat), each beside its plain PyTorch version.
- ``more4d_tpu_torch.diffusion`` — the flow-matching samplers (Euler,
  DPM++, UniPC).
- ``more4d_tpu_torch.geometry``  — projection, inverse flow normalisation,
  z-buffer rendering, camera trajectories.
- ``more4d_tpu_torch.pipelines`` — the stage-1 control and stage-2 inpaint
  pipelines.
- ``more4d_tpu_torch.infer``     — the two-stage entry point.
- ``more4d_tpu_torch.convert``   — JAX parameter trees -> state dicts, and
  released checkpoints and kohya LoRAs -> the port.
- ``more4d_tpu_torch.scripts``   — the CLIs (``python -m
  more4d_tpu_torch.scripts.infer`` and the others).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain version.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    when no card is visible instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("more4d_tpu_torch: CUDA was requested but no "
                           "CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch versions on the CPU")
    return device
