"""Each driver at a tiny configuration on the CPU, through a whole run of
the harness with its look for a chip skipped: the reference agrees with
the port; the fp8 control reads wider; and a broken timed path turns
``correct`` false, once for each fault the cell can have (a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced; one chip has no exchange to leave out)."""

import contextlib
import io
import json

import pytest
import torch

from _tiny import CELLS, TINY, run_cell
from h100_bench import harness
from h100_bench.reference.dit import CONTROLS

# bf16 products against fp32 at the tiny size read ~2e-2 (latents) and
# ~4e-2 (a leaf's norm); the cells' limits are set from full-size
# readings, so the tiny runs are held to these
TINY_LIMITS = {"latent_gap": 0.06, "loss_gap": 0.01, "grad_gap": 0.1,
               "change_gap": 0.1, "ema_gap": 0.1}


@pytest.fixture
def tiny_limits(monkeypatch):
    cell = harness.cell

    def with_tiny_limits(workload):
        w, cfg, traffic, e2e, layer = cell(workload)
        traffic = dict(traffic, limits={k: TINY_LIMITS[k]
                                        for k in traffic["limits"]})
        return w, cfg, traffic, e2e, layer
    monkeypatch.setattr(harness, "cell", with_tiny_limits)


@pytest.mark.parametrize("workload", CELLS)
def test_a_whole_run_is_correct_against_the_reference(workload, tiny_limits):
    rc, res, err = run_cell(workload)
    assert rc == 0
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    names = set(res["metrics"])
    assert "setup_s" in names and len(names) == 2
    assert list(res)[-1] == "check"
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", CELLS)
def test_the_fp8_control_reads_wider_than_the_program(workload):
    w, cfg, traffic, _, _ = harness.cell(workload)
    cfg.update(TINY)
    driver = harness.load_file(harness.HERE / "drivers" /
                               f"{traffic['driver']}.py", "d")
    seed = 2 ** 33 + 11
    prog = driver.setup(cfg, traffic, seed, torch.device("cpu"))
    for _ in range(2):
        prog.run_one()
    prog.release()
    mine = {n: v for n, v, _ in prog.verify()}
    controls = driver.setup(cfg, traffic, seed, torch.device("cpu"),
                            program=False).controls(CONTROLS)
    assert set(controls) == set(CONTROLS)
    for checks in controls.values():
        ctl = {n: v for n, v, _ in checks}
        assert any(ctl[n] > 2 * mine[n] for n in mine), (mine, ctl)
        if "latent_gap" in ctl:
            # the tiny denoise runs separate: the control is not correct
            assert ctl["latent_gap"] > TINY_LIMITS["latent_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["more4d-1.3b.straag_denoise",
                                      "more4d-1.3b.straag_train"])
def test_the_control_fails_the_limits_at_the_cells_size(workload):
    """Both fp8 controls at the cell's own size on the card (~4 min for
    the denoise cell, ~2 min for the train cell): each fails a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from h100_bench import readings

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        readings.main(["--workload", workload, "--seeds", str(2 ** 33 + 3)])
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    assert {x["control"] for x in lines} == set(CONTROLS)
    assert all(x["fails"] for x in lines), lines


def _unchanged_step(monkeypatch):
    from more4d_tpu_torch.diffusion.flow_match import FlowEulerScheduler

    monkeypatch.setattr(FlowEulerScheduler, "step",
                        lambda self, i, x, v, state: (x, state))


def _half_batch_denoise(monkeypatch):
    # the CFG-doubled forward computed on its cond half alone
    from more4d_tpu_torch.pipelines.base import BasePipeline

    fwd = BasePipeline._forward

    def half(self, x_in, t, ctx, y, clip, mpm, tc):
        if x_in.shape[0] == 2:
            out = fwd(self, x_in[1:], t[1:], ctx[1:], y[1:], clip[1:],
                      mpm[1:], tc)
            return torch.cat([out, out])
        return fwd(self, x_in, t, ctx, y, clip, mpm, tc)
    monkeypatch.setattr(BasePipeline, "_forward", half)


def _altered_answer(monkeypatch):
    from more4d_tpu_torch.pipelines.base import BasePipeline

    den = BasePipeline.denoise
    monkeypatch.setattr(BasePipeline, "denoise",
                        lambda self, *a, **kw: den(self, *a, **kw) * 1.1)


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch_train(monkeypatch):
    # batch 1: the loss's mean taken over half of the latent frames
    from more4d_tpu_torch.train import train_straag

    mse = train_straag.custom_mse_loss
    monkeypatch.setattr(train_straag, "custom_mse_loss",
                        lambda p, t, **kw: mse(p[:, : p.shape[1] // 2],
                                               t[:, : t.shape[1] // 2], **kw))


def _altered_gradient(monkeypatch):
    from more4d_tpu_torch.train.optim import GradUpdate

    call = GradUpdate.__call__
    monkeypatch.setattr(GradUpdate, "__call__",
                        lambda self, grads: call(self, [g * 1.5
                                                        for g in grads]))


def _altered_after_warm_up(monkeypatch):
    # the gradient altered only once set-up's steps are done: only the
    # window's own steps show it
    from more4d_tpu_torch.train.optim import GradUpdate

    call = GradUpdate.__call__

    def late(self, grads):
        if self.steps >= 3:
            grads = [g * 1.5 for g in grads]
        return call(self, grads)
    monkeypatch.setattr(GradUpdate, "__call__", late)


FAULTS = [("more4d-1.3b.straag_denoise", _unchanged_step),
          ("more4d-1.3b.straag_denoise", _half_batch_denoise),
          ("more4d-1.3b.straag_denoise", _altered_answer),
          ("more4d-14b-fp8.straag_denoise", _unchanged_step),
          ("more4d-14b-fp8.straag_denoise", _half_batch_denoise),
          ("more4d-14b-fp8.straag_denoise", _altered_answer),
          ("more4d-1.3b.straag_train", _unchanged_state),
          ("more4d-1.3b.straag_train", _half_batch_train),
          ("more4d-1.3b.straag_train", _altered_gradient),
          ("more4d-1.3b.straag_train", _altered_after_warm_up)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w.split('.', 1)[0]}-{w.rsplit('.', 1)[1]}-"
                              f"{f.__name__.strip('_')}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch,
                                            tiny_limits):
    fault(monkeypatch)
    rc, res, _ = run_cell(workload)
    assert rc == 0
    assert not res["correct"], res["check"]


def test_limits_are_numbers_for_every_check():
    for w in CELLS:
        _, _, traffic, _, _ = harness.cell(w)
        assert all(isinstance(v, float) and v > 0
                   for v in traffic["limits"].values())
        json.dumps(traffic)


def test_a_traced_run_reports_per_layer_metrics_only(tiny_limits):
    # on the CPU nothing runs on a device: the readers of device time find
    # nothing and leave their metrics out; mfu reads the host's window
    rc, res, _ = run_cell("more4d-1.3b.straag_denoise", trace=1,
                          seconds=0.2)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"mfu.denoise"}
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
