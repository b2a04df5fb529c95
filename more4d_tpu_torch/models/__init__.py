from .adaptors import VAEDecoderAdaptor, VAEEncoderAdaptor
from .clip import ClipVisionTower
from .dinov2 import DinoV2ViT
from .omnimae import OmniMAEViT
from .t5 import WanT5Encoder
from .unidepth import UniDepthProvider, UniDepthV2
from .wan_dit import DiTIntermediates, WanDiT
from .wan_vae import WanVAE
from .xlm_roberta import XLMRoberta, XLMRobertaWithHead

__all__ = ["WanDiT", "DiTIntermediates", "WanVAE", "VAEDecoderAdaptor",
           "VAEEncoderAdaptor", "WanT5Encoder", "ClipVisionTower",
           "OmniMAEViT", "DinoV2ViT", "UniDepthV2", "UniDepthProvider",
           "XLMRoberta", "XLMRobertaWithHead"]
