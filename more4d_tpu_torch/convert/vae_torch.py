"""The released Wan2.1 VAE checkpoint -> the port's ``WanVAE`` state dict
(PyTorch port of ``more4d_tpu/convert/vae_torch.py``).

``Wan2.1_VAE.pth`` holds ``encoder.*``, ``decoder.*``, ``conv1.*`` and
``conv2.*``, the names ``WanVAE`` holds; a file whose keys carry the
``model.`` prefix (the reference adds it when it loads) is read without
it, and its other keys dropped, as the JAX converter does.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import VAEConfig
from .dit_torch import read_state_dict


def convert_vae_state_dict(sd, cfg: VAEConfig = VAEConfig(),
                           dtype: torch.dtype = torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """The keys ``WanVAE(cfg)`` holds, without a ``model.`` prefix, in
    ``dtype``; a key it holds that the checkpoint lacks, or a shape that
    disagrees, raises with the whole list. Other keys are dropped, as the
    JAX converter never reads them, and counted."""
    from ..models.wan_vae import WanVAE

    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    with torch.device("meta"):
        own = WanVAE(cfg).state_dict()
    errors = [f"checkpoint LACKS {k}" for k in own if k not in sd]
    errors += [f"shape mismatch at {k}: checkpoint -> {tuple(sd[k].shape)}, "
               f"model expects {tuple(v.shape)}"
               for k, v in own.items() if k in sd and sd[k].shape != v.shape]
    if errors:
        raise ValueError(f"Wan VAE load failed ({len(errors)} problems):\n  "
                         + "\n  ".join(errors))
    left = len(set(sd) - set(own))
    if left:
        print(f"Wan VAE: {left} checkpoint keys not used")
    return {k: sd[k].to(dtype) for k in own}


def load_wan_vae(path: str, cfg: VAEConfig = VAEConfig(),
                 dtype: torch.dtype = torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """The released Wan2.1 VAE (``.pth`` or ``.safetensors``) as the
    port's ``WanVAE(cfg)`` state dict in ``dtype``."""
    return convert_vae_state_dict(read_state_dict(path), cfg, dtype)
