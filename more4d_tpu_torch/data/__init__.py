from .sceneflow import (SceneFlowSample, depth_to_image,
                        load_sceneflow_pickle, prepare_straag_sample)
from .vism import ViSMSample, prepare_vism_sample, project_point_cloud

__all__ = ["SceneFlowSample", "depth_to_image", "load_sceneflow_pickle",
           "prepare_straag_sample", "ViSMSample", "prepare_vism_sample",
           "project_point_cloud"]
