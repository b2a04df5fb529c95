from .attention import attention
from .layers import (Conv2d, Conv3d, LayerNormAffine, LayerNormF32, Linear,
                     RMSNorm, layer_norm, sinusoidal_embedding)
from .resize import resize
from .rope import RopeTables, apply_rope, rope_angles_3d

__all__ = [
    "attention", "Conv2d", "Conv3d", "LayerNormAffine", "LayerNormF32",
    "Linear", "RMSNorm", "layer_norm",
    "sinusoidal_embedding", "resize", "RopeTables", "apply_rope",
    "rope_angles_3d",
]
