from .adaptors import VAEDecoderAdaptor, VAEEncoderAdaptor
from .wan_dit import DiTIntermediates, WanDiT
from .wan_vae import WanVAE

__all__ = ["WanDiT", "DiTIntermediates", "WanVAE", "VAEDecoderAdaptor",
           "VAEEncoderAdaptor"]
