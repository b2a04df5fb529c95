"""The port's CAME optimizer and loss-outlier tracker
(``more4d_tpu_torch/train/optim.py``) against the JAX package's ``came``
and ``LossOutlierTracker``, on the CPU in float32.

CAME is held for three steps on a LoRA-shaped tree (matrices in torch's
[out, in] layout against JAX's [in, out], a vector, a 3-D stack): params
to 1e-6 relative (float32; the two sides factor the statistics of a
matrix and its transpose, equal up to rounding). The tracker's decisions
exactly.
"""

import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from more4d_tpu.train.optim import LossOutlierTracker as JaxTracker
from more4d_tpu.train.optim import came
from more4d_tpu.train.optim import make_lr_schedule as jax_schedule
from more4d_tpu_torch.train.optim import (CAME, LossOutlierTracker,
                                          make_lr_schedule, make_optimizer)

SHAPES = {"down": (7, 4), "up": (4, 9), "bias": (5,), "stack": (2, 3, 6)}


def _to_torch(name, a):
    """JAX layout -> the port's: 2-D matrices transposed."""
    a = np.asarray(a)
    return torch.from_numpy(a.T.copy() if a.ndim == 2 else a.copy())


@pytest.mark.parametrize("scheduled", [False, True])
def test_came_three_steps_match_jax(scheduled):
    rs = np.random.RandomState(0)
    params = {k: rs.randn(*s).astype(np.float32) * 0.1
              for k, s in SHAPES.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) * 10.0 ** -i
              for k, s in SHAPES.items()} for i in range(3)]
    if scheduled:
        lr_j = jax_schedule(1e-2, "linear", 0, 3)
        lr_t = make_lr_schedule(1e-2, "linear", 0, 3)
    else:
        lr_j = lr_t = 1e-2
    tx = came(lr_j, weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: _to_torch(k, v).requires_grad_() for k, v in params.items()}
    opt, sched = make_optimizer("came", list(tp.values()), lr_t,
                                weight_decay=1e-2)
    assert isinstance(opt, CAME) and (sched is not None) == scheduled
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _to_torch(k, g[k])
        opt.step()
        if sched is not None:
            sched.step()
        for k, p in tp.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(_to_torch(k, jp[k])),
                rtol=1e-6, atol=1e-7, err_msg=k)
    assert not np.allclose(np.asarray(jp["down"]), params["down"])


def test_came_defaults_are_the_reference_s():
    opt = CAME([torch.zeros(2, 2, requires_grad=True)])
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999, 0.9999)
    assert group["eps"] == (1e-30, 1e-16)


def test_loss_outlier_tracker_matches_jax():
    rs = np.random.RandomState(1)
    losses = list(1.0 + 0.01 * rs.randn(30))
    losses[25] = 5.0                       # above mean + 6 std
    losses += [float("nan"), float("inf"), 2e7, 1.0]
    kw = dict(window=20, sigma=6.0, warmup=5, absolute_threshold=1e7,
              multiplier=10.0)
    tj, tt = JaxTracker(**kw), LossOutlierTracker(**kw)
    got = [tt.should_skip(x) for x in losses]
    want = [tj.should_skip(x) for x in losses]
    assert got == want
    assert got[25] and got[30] and got[31] and got[32] and not got[33]
    assert all(math.isfinite(v) for v in tt.values)
    assert len(tt.values) == 20 and tt.values == tj.values

    # a flat window: the degenerate-std guard, mean * multiplier
    flat = [2.0] * 8 + [21.0, 19.0]
    tj, tt = JaxTracker(**kw), LossOutlierTracker(**kw)
    got = [tt.should_skip(x) for x in flat]
    assert got == [tj.should_skip(x) for x in flat]
    assert got[-2:] == [True, False]
