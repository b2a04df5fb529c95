from .base import (TEACACHE_COEFFICIENTS, BasePipeline, TeaCacheConfig,
                   TeaCacheState)
from .control import WanControlPipeline
from .inpaint import WanInpaintPipeline

__all__ = ["BasePipeline", "WanControlPipeline", "WanInpaintPipeline",
           "TeaCacheConfig", "TeaCacheState", "TEACACHE_COEFFICIENTS"]
