"""Flow-matching samplers: Euler, DPM-Solver++ and UniPC (PyTorch port of
``more4d_tpu/diffusion/flow_match.py``).

The model predicts the flow velocity v = eps - x0 for x_t = (1 - sigma) x0
+ sigma eps. The sigmas are computed in numpy exactly as the JAX package
computes them, and every per-step coefficient in float32 (0-d tensors), as
the JAX samplers compute theirs, before it scales a latent. The JAX
samplers pick each step's branch with ``jnp.where`` under a traced step
index; here the index is a Python int and only the branch taken is
computed.

- Euler: diffusers' FlowMatchEulerDiscreteScheduler (the default 'flow').
- DPM++ (``FlowDPMScheduler``): solver order 1-3, midpoint/heun, the four
  algorithm types, dynamic thresholding, euler_at_final. The sde variants
  take ``step(..., noise=)``, or draw from the ``torch.Generator`` that
  ``init_state`` seeds with ``sde_seed`` on the latents' device and carries
  in the state (the JAX sampler draws from ``fold_in(PRNGKey(sde_seed),
  i)``, so the two packages draw different noise).
- UniPC (``FlowUniPCScheduler``): solver order 1-3, bh1/bh2, predict_x0
  both ways, thresholding, disable_corrector.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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


def sampling_sigmas(num_steps: int, shift: float) -> np.ndarray:
    """The DPM++/UniPC schedule: linspace(1, 0)[:n] shifted, final sigma 0
    appended. Returns [num_steps + 1] float32."""
    s = np.linspace(1, 0, num_steps + 1)[:num_steps]
    s = shift_sigmas(s, shift)
    return np.concatenate([s, [0.0]]).astype(np.float32)


def _lam(sigma: torch.Tensor) -> torch.Tensor:
    """lambda(sigma) = log(alpha) - log(sigma), alpha = 1 - sigma, both
    clamped at 1e-10 (float32)."""
    return (torch.log(torch.clamp(1.0 - sigma, min=1e-10))
            - torch.log(torch.clamp(sigma, min=1e-10)))


def _safe(r: torch.Tensor) -> float:
    """A divisor that is 1 where |r| <= 1e-10."""
    return float(r) if abs(float(r)) > 1e-10 else 1.0


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

    def init_state(self, shape, dtype=torch.float32, device=None):
        return ()

    def step(self, i: int, x: torch.Tensor, v: torch.Tensor, state):
        # the step size is a float32 difference, as in the JAX sampler
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        out = x.float() + dt * v.float()
        return out.to(x.dtype), state


def _threshold_sample(x0: torch.Tensor, ratio: float, max_value: float):
    """Dynamic thresholding: clamp each sample's x0 to +-s, s = the
    ``ratio`` quantile of |x0| over its non-batch dims clamped to [1,
    max_value], then divide by s."""
    b = x0.shape[0]
    s = torch.quantile(x0.reshape(b, -1).abs(), ratio, dim=1)
    s = s.clamp(1.0, max_value).reshape((b,) + (1,) * (x0.ndim - 1))
    return torch.maximum(torch.minimum(x0, s), -s) / s


def _convert(xf, vf, sigma, thresholding, ratio, max_value, predict_x0):
    """The converted model output: the x0 prediction, or epsilon."""
    x0 = xf - float(sigma) * vf
    if thresholding:
        x0 = _threshold_sample(x0, ratio, max_value)
    if predict_x0:
        return x0
    if thresholding:
        return vf + x0
    return xf - float(1.0 - sigma) * vf


@dataclasses.dataclass(frozen=True)
class FlowDPMScheduler:
    """FlowDPMSolverMultistepScheduler with the JAX sampler's knobs;
    defaults are the inference pipeline's (dpmsolver++ order 2
    midpoint)."""

    sigmas: np.ndarray
    solver_order: int = 2             # 1 | 2 | 3
    solver_type: str = "midpoint"     # 'midpoint' | 'heun'
    algorithm_type: str = "dpmsolver++"
    lower_order_final: bool = True
    euler_at_final: bool = False
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    sde_seed: int = 0

    def __post_init__(self):
        if self.solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order {self.solver_order}")
        if self.solver_type not in ("midpoint", "heun"):
            raise ValueError(f"solver_type {self.solver_type!r}")
        if self.algorithm_type not in ("dpmsolver++", "dpmsolver",
                                       "sde-dpmsolver++", "sde-dpmsolver"):
            raise ValueError(f"algorithm_type {self.algorithm_type!r}")
        if self.solver_order == 3 and self._sde:
            # the reference has a third-order update only for the
            # deterministic algorithms
            raise ValueError("solver_order 3 needs dpmsolver++ or dpmsolver")

    @classmethod
    def create(cls, num_steps, shift, **kw):
        return cls(sampling_sigmas(num_steps, shift), **kw)

    @property
    def timesteps(self) -> np.ndarray:
        return self.sigmas[:-1] * 1000.0

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    @property
    def _pp(self) -> bool:
        return self.algorithm_type.endswith("++")

    @property
    def _sde(self) -> bool:
        return self.algorithm_type.startswith("sde")

    def init_state(self, shape, dtype=torch.float32, device=None):
        """The previous converted outputs (x0 for ++, epsilon otherwise;
        two at order 3), and for the sde variants the noise generator."""
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        state = (z, z) if self.solver_order == 3 else (z,)
        if self._sde:
            state += (torch.Generator(z.device).manual_seed(self.sde_seed),)
        return state

    def step(self, i: int, x: torch.Tensor, v: torch.Tensor, state,
             noise: Optional[torch.Tensor] = None):
        n = self.num_steps
        sig = torch.from_numpy(self.sigmas)
        xf, vf = x.float(), v.float()
        m0 = _convert(xf, vf, sig[i], self.thresholding,
                      self.dynamic_thresholding_ratio, self.sample_max_value,
                      self._pp)
        m1 = state[0]
        s_t, s_s0, s_s1 = sig[i + 1], sig[i], sig[max(i - 1, 0)]
        a_t, a_s0 = 1.0 - s_t, 1.0 - s_s0
        h = _lam(s_t) - _lam(s_s0)
        r0 = (_lam(s_s0) - _lam(s_s1)) / h
        ratio = s_t / torch.clamp(s_s0, min=1e-10)
        em, ep = torch.exp(-h) - 1.0, torch.exp(h) - 1.0
        if self._sde and noise is None:
            gen = state[-1]
            noise = torch.randn(x.shape, generator=gen, device=gen.device,
                                dtype=torch.float32)
        if noise is not None:
            noise = noise.to(xf.device, torch.float32)

        algo = self.algorithm_type
        if algo == "dpmsolver++":
            first = float(ratio) * xf - float(a_t * em) * m0
        elif algo == "dpmsolver":
            first = float(a_t / a_s0) * xf - float(s_t * ep) * m0
        elif algo == "sde-dpmsolver++":
            e2 = 1.0 - torch.exp(-2.0 * h)
            first = (float(ratio * torch.exp(-h)) * xf + float(a_t * e2) * m0
                     + float(s_t * torch.sqrt(torch.clamp(e2, min=0.0)))
                     * noise)
        else:
            e2 = torch.exp(2.0 * h) - 1.0
            first = (float(a_t / a_s0) * xf - float(2.0 * s_t * ep) * m0
                     + float(s_t * torch.sqrt(torch.clamp(e2, min=0.0)))
                     * noise)
        out, new_state = first, (m0,)

        low_final = bool(self.euler_at_final
                         or (self.lower_order_final and n < 15)
                         or self.sigmas[-1] == 0.0)
        use_third = (self.solver_order == 3 and i >= 2
                     and not (self.lower_order_final and n < 15
                              and i == n - 2)
                     and not (low_final and i == n - 1))
        use_second = (self.solver_order >= 2 and not use_third and i >= 1
                      and not (low_final and i == n - 1))
        if use_second:
            d1 = (m0 - m1) / _safe(r0)
            mid = self.solver_type == "midpoint"
            if algo == "dpmsolver++":
                c = 0.5 * a_t * em if mid else -a_t * (em / h + 1.0)
                out = first - float(c) * d1
            elif algo == "dpmsolver":
                c = 0.5 * s_t * ep if mid else s_t * (ep / h - 1.0)
                out = first - float(c) * d1
            elif algo == "sde-dpmsolver++":
                e2 = 1.0 - torch.exp(-2.0 * h)
                c = 0.5 * a_t * e2 if mid else a_t * (e2 / (-2.0 * h) + 1.0)
                out = first + float(c) * d1
            else:
                c = s_t * ep if mid else 2.0 * s_t * (ep / h - 1.0)
                out = first - float(c) * d1
        if use_third:
            m2 = state[1]
            s_s2 = sig[max(i - 2, 0)]
            r1 = (_lam(s_s1) - _lam(s_s2)) / h
            d1_0 = (m0 - m1) / _safe(r0)
            d1_1 = (m1 - m2) / _safe(r1)
            rsum = _safe(r0 + r1)
            d1_3 = d1_0 + float(r0 / rsum) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / rsum
            if algo == "dpmsolver++":
                out = (float(ratio) * xf - float(a_t * em) * m0
                       + float(a_t * (em / h + 1.0)) * d1_3
                       - float(a_t * ((em + h) / h ** 2 - 0.5)) * d2)
            else:
                out = (float(a_t / a_s0) * xf - float(s_t * ep) * m0
                       - float(s_t * (ep / h - 1.0)) * d1_3
                       - float(s_t * ((ep - h) / h ** 2 - 0.5)) * d2)
        if self.solver_order == 3:
            new_state = (m0, m1)
        if self._sde:
            new_state += (state[-1],)
        return out.to(x.dtype), new_state


def _unipc_bh_coeffs(h: torch.Tensor, order: int, solver_type: str,
                     predict_x0: bool):
    """(hh, h_phi_1, B_h, b[0..order-1]) of the UniPC B(h) update (the
    reference's factorial recurrence)."""
    hh = -h if predict_x0 else h
    h_phi_1 = torch.expm1(hh)
    h_phi_k = h_phi_1 / hh - 1.0
    b_h = hh if solver_type == "bh1" else torch.expm1(hh)
    bs = []
    factorial_i = 1.0
    for k in range(1, order + 1):
        bs.append(h_phi_k * factorial_i / b_h)
        factorial_i *= k + 1
        h_phi_k = h_phi_k / hh - 1.0 / factorial_i
    return hh, h_phi_1, b_h, bs


def _solve_rhos(rks, bs) -> torch.Tensor:
    """Solve the Vandermonde system R rhos = b (R_kj = rks_j^k), at most
    3x3, in float32."""
    r = torch.stack([torch.stack([rk ** k for rk in rks])
                     for k in range(len(bs))])
    return torch.linalg.solve(r, torch.stack(bs))


@dataclasses.dataclass(frozen=True)
class FlowUniPCScheduler:
    """FlowUniPCMultistepScheduler with the JAX sampler's knobs; defaults
    are the inference pipeline's (bh2, predict_x0, order 2,
    predictor-corrector)."""

    sigmas: np.ndarray
    solver_order: int = 2
    solver_type: str = "bh2"          # 'bh1' | 'bh2'
    predict_x0: bool = True
    lower_order_final: bool = True
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    disable_corrector: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.solver_order not in (1, 2, 3):
            raise ValueError(f"solver_order {self.solver_order}")
        if self.solver_type not in ("bh1", "bh2"):
            raise ValueError(f"solver_type {self.solver_type!r}")

    @classmethod
    def create(cls, num_steps, shift, **kw):
        return cls(sampling_sigmas(num_steps, shift), **kw)

    @property
    def timesteps(self) -> np.ndarray:
        return self.sigmas[:-1] * 1000.0

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    def init_state(self, shape, dtype=torch.float32, device=None):
        """(m_{i-1}, m_{i-2}[, m_{i-3}], the last corrected sample)."""
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return (z,) * self.solver_order + (z,)

    def _order(self, i: int) -> int:
        """The predictor's order at step i: the warm-up, and the lower
        orders of the tail."""
        order = (min(self.solver_order, self.num_steps - i)
                 if self.lower_order_final else self.solver_order)
        return min(order, min(i, self.solver_order) + 1)

    def _ab(self, s_t, s_s0):
        """(coefficient of the old sample, of the residual)."""
        if self.predict_x0:
            return s_t / torch.clamp(s_s0, min=1e-10), 1.0 - s_t
        return (1.0 - s_t) / (1.0 - s_s0), s_t

    def _corrected(self, i, sig, ms, last_sample, m0):
        """UniC: the current sample corrected with the model output at it,
        at the previous predictor's order."""
        s_t, s_s0 = sig[i], sig[max(i - 1, 0)]
        h = _lam(s_t) - _lam(s_s0)
        c_old, c_res = self._ab(s_t, s_s0)
        order = self._order(max(i - 1, 0))
        rks, d1s = [], []
        for j in range(1, order):
            rk = (_lam(sig[max(i - (j + 1), 0)]) - _lam(s_s0)) / h
            rks.append(rk)
            d1s.append((ms[j] - ms[0]) / _safe(rk))
        _, h_phi_1, b_h, bs = _unipc_bh_coeffs(h, order, self.solver_type,
                                               self.predict_x0)
        x_t_ = float(c_old) * last_sample - float(c_res * h_phi_1) * ms[0]
        rhos = ([torch.tensor(0.5)] if order == 1 else
                _solve_rhos(rks + [torch.ones(())], bs))
        res = sum(float(rhos[j]) * d1s[j] for j in range(order - 1))
        return x_t_ - float(c_res * b_h) * (res + float(rhos[order - 1])
                                            * (m0 - ms[0]))

    def step(self, i: int, x: torch.Tensor, v: torch.Tensor, state):
        p = self.solver_order
        ms, last_sample = state[:p], state[p]   # ms[0] = m_{i-1}, ...
        sig = torch.from_numpy(self.sigmas)
        xf, vf = x.float(), v.float()
        m0 = _convert(xf, vf, sig[i], self.thresholding,
                      self.dynamic_thresholding_ratio, self.sample_max_value,
                      self.predict_x0)

        # the corrector is off at step i when step i - 1 is listed
        use_corr = i > 0 and (i - 1) not in self.disable_corrector
        x_corr = self._corrected(i, sig, ms, last_sample, m0) if use_corr \
            else xf

        # the predictor (UniP), from the corrected sample
        s_t, s_s0 = sig[i + 1], sig[i]
        h = _lam(s_t) - _lam(s_s0)
        c_old, c_res = self._ab(s_t, s_s0)
        order = self._order(i)
        _, h_phi_1, b_h, bs = _unipc_bh_coeffs(h, order, self.solver_type,
                                               self.predict_x0)
        out = float(c_old) * x_corr - float(c_res * h_phi_1) * m0
        if order >= 2:
            rks, d1s = [], []
            for j in range(1, order):
                rk = (_lam(sig[max(i - j, 0)]) - _lam(s_s0)) / h
                rks.append(rk)
                d1s.append((ms[j - 1] - m0) / _safe(rk))
            rhos = [0.5] if order == 2 else \
                [float(r) for r in _solve_rhos(rks, bs[:-1])]
            res = sum(float(rhos[j]) * d1s[j] for j in range(order - 1))
            out = out - float(c_res * b_h) * res
        new_ms = (m0,) + tuple(ms[:p - 1])
        return out.to(x.dtype), new_ms + (x_corr,)


def get_scheduler(name: str, num_steps: int, shift: float,
                  num_train_timesteps: int = 1000, **kw):
    """'flow' | 'flow_unipc' | 'flow_dpm++' (or 'flow_dpm'); extra kwargs
    go to the solver (solver_order, solver_type, algorithm_type,
    thresholding, ...)."""
    if name == "flow":
        if kw:
            raise ValueError(f"the Euler sampler has no solver knobs: {kw}")
        return FlowEulerScheduler.create(num_steps, shift,
                                         num_train_timesteps)
    if name == "flow_unipc":
        return FlowUniPCScheduler.create(num_steps, shift, **kw)
    if name in ("flow_dpm++", "flow_dpm"):
        return FlowDPMScheduler.create(num_steps, shift, **kw)
    raise ValueError(f"unknown scheduler {name}")
