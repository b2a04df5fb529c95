from .base import BasePipeline
from .control import WanControlPipeline
from .inpaint import WanInpaintPipeline

__all__ = ["BasePipeline", "WanControlPipeline", "WanInpaintPipeline"]
