from .buckets import (ASPECT_RATIO_512, AspectRatioBatchSampler,
                      ResumableSampler, closest_bucket)
from .masks import get_random_mask
from .sceneflow import (SceneFlowSample, depth_to_image,
                        load_sceneflow_pickle, prepare_straag_sample)
from .vism import ViSMSample, prepare_vism_sample, project_point_cloud

__all__ = ["ASPECT_RATIO_512", "AspectRatioBatchSampler", "ResumableSampler",
           "closest_bucket", "get_random_mask", "SceneFlowSample",
           "depth_to_image", "load_sceneflow_pickle", "prepare_straag_sample",
           "ViSMSample", "prepare_vism_sample", "project_point_cloud"]
