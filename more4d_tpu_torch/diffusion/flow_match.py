"""Flow-matching Euler sampler (PyTorch port of
``more4d_tpu/diffusion/flow_match.py``).

The model predicts the flow velocity v = eps - x0 for x_t = (1 - sigma) x0
+ sigma eps. The sigmas are computed in numpy exactly as the JAX package
computes them; only the Euler sampler is ported so far.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    """Timestep shift warp."""
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def euler_sigmas(num_steps: int, shift: float,
                 num_train_timesteps: int = 1000) -> np.ndarray:
    """FlowMatchEuler schedule: linspace(1, 1/T) shifted, final sigma 0.
    Returns [num_steps + 1] float32."""
    s = np.linspace(1.0, 1.0 / num_train_timesteps, num_steps)
    s = shift_sigmas(s, shift)
    return np.concatenate([s, [0.0]]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FlowEulerScheduler:
    """x' = x + (sigma_next - sigma) * v. Stateless."""

    sigmas: np.ndarray  # [n+1] float32

    @classmethod
    def create(cls, num_steps, shift, num_train_timesteps=1000):
        return cls(euler_sigmas(num_steps, shift, num_train_timesteps))

    @property
    def timesteps(self) -> np.ndarray:
        return self.sigmas[:-1] * 1000.0

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    def init_state(self, shape, dtype=torch.float32):
        return ()

    def step(self, i: int, x: torch.Tensor, v: torch.Tensor, state):
        # the step size is a float32 difference, as in the JAX sampler
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        out = x.float() + dt * v.float()
        return out.to(x.dtype), state


def get_scheduler(name: str, num_steps: int, shift: float,
                  num_train_timesteps: int = 1000, **kw):
    """'flow' (the Euler sampler). The JAX package's 'flow_unipc' and
    'flow_dpm++' are not ported yet."""
    if name == "flow":
        if kw:
            raise ValueError(f"the Euler sampler has no solver knobs: {kw}")
        return FlowEulerScheduler.create(num_steps, shift,
                                         num_train_timesteps)
    if name in ("flow_unipc", "flow_dpm++", "flow_dpm"):
        raise NotImplementedError(f"scheduler {name!r} is not ported to "
                                  f"PyTorch yet (only 'flow')")
    raise ValueError(f"unknown scheduler {name}")
