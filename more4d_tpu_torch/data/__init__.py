from .sceneflow import (SceneFlowSample, depth_to_image,
                        load_sceneflow_pickle, prepare_straag_sample)

__all__ = ["SceneFlowSample", "depth_to_image", "load_sceneflow_pickle",
           "prepare_straag_sample"]
