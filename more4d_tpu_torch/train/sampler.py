"""Timestep sampling for training (PyTorch port of
``more4d_tpu/train/sampler.py``): rank-stratified uniform indices, the SD3
sampling densities and the SD3 loss weighting.

Every draw takes an explicit ``torch.Generator``. The numbers differ from
``jax.random``'s for the same seed; the tests hand JAX's draws to the
port's train step instead.
"""

from __future__ import annotations

import math

import torch


def timestep_density_u(generator: torch.Generator, weighting_scheme: str,
                       batch_size: int, logit_mean: float = 0.0,
                       logit_std: float = 1.0, mode_scale: float = 1.29,
                       device=None) -> torch.Tensor:
    """SD3 timestep-density sampling: u [batch_size] in [0, 1); indices are
    floor(u * num_train_timesteps).

    - 'logit_normal': u = sigmoid(N(logit_mean, logit_std))
    - 'mode':         u ~ U[0,1); u <- 1 - u - mode_scale*(cos(pi u/2)^2 - 1 + u)
    - else ('none', 'sigma_sqrt', 'cosmap'): u ~ U[0,1)
    """
    if weighting_scheme == "logit_normal":
        u = torch.randn(batch_size, generator=generator, device=device)
        return torch.sigmoid(u * logit_std + logit_mean)
    u = torch.rand(batch_size, generator=generator, device=device)
    if weighting_scheme == "mode":
        u = 1.0 - u - mode_scale * (
            torch.cos(math.pi * u / 2.0) ** 2 - 1.0 + u)
    return u


def loss_weighting_sd3(weighting_scheme: str, sigmas) -> torch.Tensor:
    """SD3 per-sample loss weighting: only 'sigma_sqrt' and 'cosmap'
    differ from ones."""
    sigmas = torch.as_tensor(sigmas, dtype=torch.float32)
    if weighting_scheme == "sigma_sqrt":
        return sigmas ** -2.0
    if weighting_scheme == "cosmap":
        bot = 1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2
        return 2.0 / (math.pi * bot)
    return torch.ones_like(sigmas)


class StratifiedTimestepSampler:
    """The world is split into groups; each group draws its indices from
    its own disjoint interval, so a global batch covers the schedule
    evenly. With one rank (or uniform_sampling off) it draws from the whole
    range."""

    def __init__(self, num_idx: int, uniform_sampling: bool = True,
                 start_num_idx: int = 0, world_size: int = 1,
                 sp_size: int = 1):
        self.num_idx = num_idx
        self.start = start_num_idx
        self.uniform = uniform_sampling and world_size > 1

        if self.uniform:
            i = 1
            while True:
                if world_size % i != 0 or num_idx % (world_size // i) != 0:
                    i += 1
                    continue
                if i >= sp_size:
                    self.group_num = world_size // i
                elif sp_size > world_size:
                    self.group_num = 1
                else:
                    self.group_num = world_size // sp_size
                break
            self.group_width = world_size // self.group_num
            self.sigma_interval = self.num_idx // self.group_num
        else:
            self.group_num = 1
            self.group_width = max(world_size, 1)
            self.sigma_interval = num_idx

    def __call__(self, generator: torch.Generator, n_samples: int,
                 rank: int = 0, device=None) -> torch.Tensor:
        """int64 indices [n_samples]."""
        if not self.uniform:
            return torch.randint(self.start, self.start + self.num_idx,
                                 (n_samples,), generator=generator,
                                 device=device)
        lo = self.start + (rank // self.group_width) * self.sigma_interval
        return lo + torch.randint(0, self.sigma_interval, (n_samples,),
                                  generator=generator, device=device)
