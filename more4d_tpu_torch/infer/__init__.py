from .two_stage import (TwoStageModels, build_two_stage_models,
                        render_trajectories, run_two_stage, stage1_generate,
                        stage2_inpaint, stage2_inpaint_batch)

__all__ = ["TwoStageModels", "build_two_stage_models", "stage1_generate",
           "render_trajectories", "stage2_inpaint", "stage2_inpaint_batch",
           "run_two_stage"]
