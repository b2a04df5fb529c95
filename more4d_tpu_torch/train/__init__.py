from .checkpoint import CheckpointManager
from .harness import StraagRunConfig, StraagTrainer
from .optim import (custom_mse_loss, dynamic_clip_norm, ema_update,
                    global_grad_norm, make_adamw, make_lr_schedule,
                    motion_sub_loss)
from .sampler import (StratifiedTimestepSampler, loss_weighting_sd3,
                      timestep_density_u)
from .train_straag import (StraagTrainConfig, draw, should_skip_update,
                           train_step, training_schedule)

__all__ = [
    "CheckpointManager", "StraagRunConfig", "StraagTrainer",
    "custom_mse_loss", "dynamic_clip_norm", "ema_update", "global_grad_norm",
    "make_adamw", "make_lr_schedule", "motion_sub_loss",
    "StratifiedTimestepSampler", "loss_weighting_sd3", "timestep_density_u",
    "StraagTrainConfig", "draw", "should_skip_update", "train_step",
    "training_schedule",
]
