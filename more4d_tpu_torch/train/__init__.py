from .checkpoint import CheckpointManager
from .harness import StraagRunConfig, StraagTrainer
from .optim import (CAME, GradUpdate, LossOutlierTracker, custom_mse_loss,
                    dynamic_clip_norm, ema_update, global_grad_norm,
                    make_adamw, make_lr_schedule, make_optimizer,
                    motion_sub_loss)
from .sampler import (StratifiedTimestepSampler, loss_weighting_sd3,
                      timestep_density_u)
from .train_straag import (StraagTrainConfig, draw, should_skip_update,
                           train_step, training_schedule)
from .train_vae import VAEAdaptorTrainConfig
from .train_vism import VismTrainConfig

__all__ = [
    "CAME", "CheckpointManager", "GradUpdate", "LossOutlierTracker",
    "StraagRunConfig", "StraagTrainer", "VAEAdaptorTrainConfig",
    "VismTrainConfig",
    "custom_mse_loss", "dynamic_clip_norm", "ema_update", "global_grad_norm",
    "make_adamw", "make_lr_schedule", "make_optimizer", "motion_sub_loss",
    "StratifiedTimestepSampler", "loss_weighting_sd3", "timestep_density_u",
    "StraagTrainConfig", "draw", "should_skip_update", "train_step",
    "training_schedule",
]
