"""Weight conversion for the port.

- ``params``: the JAX package's parameter trees -> the port's state dicts
  (tests hand the same weights to both packages through it);
- ``dit_torch``, ``vae_torch``, ``lora_torch``: released checkpoints
  (``.safetensors`` shards, ``.pth``) and kohya LoRAs -> the port's state
  dicts, with the JAX package's checks and checkpoint surgery.
"""

from .params import (adaptor_state_dict, clip_vision_state_dict,
                     dinov2_state_dict, dit_state_dict, lora_factors,
                     omnimae_state_dict, t5_state_dict, unidepth_state_dict,
                     vae_state_dict)

__all__ = ["dit_state_dict", "vae_state_dict", "adaptor_state_dict",
           "t5_state_dict", "clip_vision_state_dict", "omnimae_state_dict",
           "dinov2_state_dict", "unidepth_state_dict", "lora_factors"]
