from ..diffusion.loop import (TEACACHE_COEFFICIENTS, ScheduleTeaCache,
                              TeaCacheConfig, TeaCacheState)
from .base import BasePipeline
from .control import WanControlPipeline
from .inpaint import WanInpaintPipeline

__all__ = ["BasePipeline", "WanControlPipeline", "WanInpaintPipeline",
           "TeaCacheConfig", "TeaCacheState", "ScheduleTeaCache",
           "TEACACHE_COEFFICIENTS"]
