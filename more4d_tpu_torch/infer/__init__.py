from .encoders import (ConditioningEncoders, build_clip_encoder,
                       build_encoders, build_mpm_extractor,
                       build_text_encoder, build_tokenize)
from .two_stage import (TwoStageModels, build_two_stage_models,
                        make_two_stage_models, render_trajectories, run_two_stage, stage1_generate,
                        stage2_inpaint, stage2_inpaint_batch,
                        stage2_inpaint_dp)

__all__ = ["TwoStageModels", "build_two_stage_models",
           "make_two_stage_models", "stage1_generate",
           "render_trajectories", "stage2_inpaint", "stage2_inpaint_batch",
           "stage2_inpaint_dp",
           "run_two_stage", "ConditioningEncoders", "build_encoders",
           "build_text_encoder", "build_clip_encoder", "build_mpm_extractor",
           "build_tokenize"]
