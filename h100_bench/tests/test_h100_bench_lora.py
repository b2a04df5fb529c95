"""The streamed 14B InP LoRA cell (``more4d-14b-inp-stream.vism_lora_train``,
driver ``vism_lora_train``) at a tiny configuration on the CPU: a whole
run is correct against the plain reference (``reference/lora.py``); each
planted fault, in the program or in the reference, turns ``correct``
false; the fp8 controls read wider; the program opens its new spans once
a step where they run; and the new readers on hand-made traces, reading
nothing where the program has no such span."""

import io
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _tiny import TINY, run_cell
from h100_bench import harness
from h100_bench.reference import lora as ref_lora
from h100_bench.reference.dit import CONTROLS
from h100_bench.yardstick import lora
from h100_bench.yardstick import trace as tr

CELL = "more4d-14b-inp-stream.vism_lora_train"
ROOT = harness.ROOT
COPY = "Memcpy HtoD (Pinned -> Device)"
LINEARS = 12            # the factored Linears of an i2v block
NEW = ("mfu.lora_train", "lora_side_ms.lora_train",
       "stream_exposed_ms.lora_train", "walk_idle_ms.lora_train")


# bf16 against fp32 at the tiny size reads 9e-4 (loss), 1.4e-2 (a
# factor's gradient) and 1.0e-2 (its change); the cell's limits are set
# from full-size readings, so the tiny runs are held to these, with 3x
# room or more
TINY_LIMITS = {"loss_gap": 0.003, "grad_gap": 0.05, "change_gap": 0.05}


@pytest.fixture
def tiny_limits(monkeypatch):
    cell = harness.cell

    def with_tiny_limits(workload):
        w, cfg, traffic, e2e, layer = cell(workload)
        return w, cfg, dict(traffic, limits=TINY_LIMITS), e2e, layer
    monkeypatch.setattr(harness, "cell", with_tiny_limits)


def _reader(name):
    return harness.load_file(ROOT / "h100_bench" / "metrics" / f"{name}.py",
                             "m_" + name.replace(".", "_"))


def _session(seed=2 ** 33 + 11, program=True):
    w, cfg, traffic, _, _ = harness.cell(CELL)
    cfg.update(TINY)
    driver = harness.load_file(harness.HERE / "drivers" /
                               f"{traffic['driver']}.py", "d")
    return driver.setup(cfg, traffic, seed, torch.device("cpu"), program)


def test_a_whole_run_is_correct_against_the_reference(tiny_limits):
    rc, res, err = run_cell(CELL)
    assert rc == 0
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "train_step_s"}
    assert set(res["check"]) == {"loss_gap", "grad_gap", "change_gap"}
    # the side paths a step: 12 a block, in both walks
    counted = next(x for x in err.splitlines()
                   if x.startswith("counters a step"))
    assert f"'side_paths': {2 * TINY['num_layers'] * LINEARS}.0" in counted


def test_the_timed_path_is_the_clis_streamed_trainer(monkeypatch):
    from more4d_tpu_torch.train import train_vism
    from more4d_tpu_torch.train.lora_streamed import StreamedLoRATrainer

    calls = []
    step = StreamedLoRATrainer.train_step
    monkeypatch.setattr(StreamedLoRATrainer, "train_step",
                        lambda self, *a: (calls.append("streamed"),
                                          step(self, *a))[1])
    monkeypatch.setattr(train_vism, "train_step",
                        lambda *a, **kw: calls.append("resident"))
    rc, res, _ = run_cell(CELL)
    assert rc == 0 and calls and set(calls) == {"streamed"}


def test_the_seeded_factors_are_the_programs_targets():
    from more4d_tpu_torch.train.train_vism import factor_leaves

    sess = _session()
    assert list(sess.lora["factors"]) == sorted(
        n for ws in ref_lora.targets(sess.cfg).values() for n, _, _ in ws)
    # the driver's names follow the program's order of leaves
    want = ref_lora.factors(sess.cfg, sess.seed, torch.device("cpu"))
    for n, p in zip(sess.names, factor_leaves(sess.lora)):
        weight, k = n.rsplit(".", 1)
        assert p.shape == want[weight][k].shape
    # up is non-zero: the side path acts from the first step, and down
    # takes a gradient
    assert all(f["up"].abs().max() > 0 for f in want.values())
    assert len(lora.factored_linears(sess.cfg)) == LINEARS


def _side_path_dropped(monkeypatch):
    # the side path still in the graph, its output multiplied by 0: the
    # factors take zero gradients
    from more4d_tpu_torch.train.lora_streamed import StreamedLoRATrainer

    side = StreamedLoRATrainer._side_path

    def dropped(self, path):
        hook = side(self, path)

        def run(module, args, out):
            return out + 0.0 * (hook(module, args, out) - out)
        return run
    monkeypatch.setattr(StreamedLoRATrainer, "_side_path", dropped)


def _wrong_block_gradient(monkeypatch):
    # block 0's factors take block 1's gradients (the leaves are in name
    # order: each block's 2 x 12 leaves together)
    from more4d_tpu_torch.train.optim import GradUpdate

    call = GradUpdate.__call__
    n = 2 * LINEARS

    def swapped(self, grads):
        return call(self, grads[n:2 * n] + grads[n:])
    monkeypatch.setattr(GradUpdate, "__call__", swapped)


def _reference_in_bf16(monkeypatch):
    # the reference's frozen block weights left in bf16, not the fp8
    # the streamed configuration stores
    monkeypatch.setattr(ref_lora, "stored_streamed", lambda name: False)


FAULTS = [_side_path_dropped, _wrong_block_gradient, _reference_in_bf16]


@pytest.mark.parametrize("fault", FAULTS,
                         ids=[f.__name__.strip("_") for f in FAULTS])
def test_a_planted_fault_is_not_correct(fault, monkeypatch, tiny_limits):
    fault(monkeypatch)
    rc, res, _ = run_cell(CELL)
    assert rc == 0
    assert not res["correct"], res["check"]


def test_the_fp8_controls_read_wider_than_the_program():
    prog = _session()
    for _ in range(2):
        prog.run_one()
    prog.release()
    mine = {n: v for n, v, _ in prog.verify()}
    controls = _session(program=False).controls(CONTROLS)
    assert set(controls) == set(CONTROLS)
    for checks in controls.values():
        ctl = {n: v for n, v, _ in checks}
        assert any(ctl[n] > 2 * mine[n] for n in mine), (mine, ctl)
        assert any(ctl[n] > TINY_LIMITS[n] for n in ctl), ctl


def test_the_new_spans_open_once_a_step_where_they_run():
    sess = _session()
    steps = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            sess.run_one()
    names = [e.name for e in prof.events()
             if e.name.startswith("more4d.lora.")]
    for part in ("forward_walk", "loss", "backward_walk", "update"):
        assert names.count(f"more4d.lora.{part}") == steps
    assert names.count("more4d.lora.side") == \
        steps * 2 * TINY["num_layers"] * LINEARS


def _trace(acts, spans, window=1000):
    """acts: (name, start, end, launch ts); spans: (name, start, end). One
    thread; the window is [0, window]."""
    activities, launches = [], {}
    for corr, (name, s, e, ts) in enumerate(acts, 1):
        activities.append(tr.Activity(name, s, e, corr,
                                      not name.startswith("Memcpy")))
        launches[corr] = (ts, 1)
    sp = [tr.Span(tr.WINDOW, 0, window, 1)] + [tr.Span(n, s, e, 1)
                                                for n, s, e in spans]
    return tr.Trace(activities, launches, sp)


def _step():
    """One step: the forward walk [10, 50] fetches block 0 [100, 200],
    nothing to hide it, and block 1 [210, 300], under block 0's kernel
    but its last 10; a side path's kernel [250, 270]; the backward walk
    [60, 90] fetches again [500, 540] under a kernel [480, 560] with a
    side kernel [560, 570]; a copy fetched outside any walk."""
    acts = [(COPY, 100, 200, 15),
            (COPY, 210, 300, 25),
            ("k_block0", 200, 290, 30),
            ("k_side", 250, 270, 35),
            ("k_block1", 300, 400, 40),
            (COPY, 500, 540, 65),
            ("k_bwd", 480, 560, 62),
            ("k_side", 560, 570, 70),
            (COPY, 700, 800, 95)]                  # outside the walks
    spans = [("more4d.lora.forward_walk", 10, 50),
             ("more4d.stream.fetch", 12, 16),
             ("more4d.stream.fetch", 22, 26),
             ("more4d.lora.side", 34, 36),
             ("more4d.lora.backward_walk", 60, 90),
             ("more4d.stream.fetch", 64, 66),
             ("more4d.lora.side", 69, 71),
             ("more4d.stream.fetch", 94, 96)]
    return _trace(acts, spans)


def test_the_readers_on_a_hand_made_step():
    ctx = SimpleNamespace(trace=_step(), trace_units=2)
    # the fetched copies within the walks, less the kernels: [100, 200]
    # and [290, 300]; over 2 steps
    assert _reader("stream_exposed_ms.lora_train").read(ctx) == \
        pytest.approx(110 / 1e6 / 2)
    # the side path's kernels: 20 + 10
    assert _reader("lora_side_ms.lora_train").read(ctx) == \
        pytest.approx(30 / 1e6 / 2)
    # device idle while the host is in a walk: nothing runs in [10, 50]
    # or [60, 90] (the kernels start at 100)
    assert _reader("walk_idle_ms.lora_train").read(ctx) == \
        pytest.approx(70 / 1e6 / 2)


@pytest.mark.parametrize("absent", ["walks", "side", "fetch", "device"])
def test_the_readers_read_nothing_where_the_program_has_no_such_span(
        absent):
    t = _step()
    if absent == "walks":       # the parent's trainer: no walk span
        t.spans = [s for s in t.spans if not s.name.endswith("_walk")]
    elif absent == "side":      # no side span
        t.spans = [s for s in t.spans if s.name != "more4d.lora.side"]
    elif absent == "fetch":
        t.spans = [s for s in t.spans if s.name != "more4d.stream.fetch"]
    else:                       # a trace of the host alone
        t.activities = []
    ctx = SimpleNamespace(trace=t, trace_units=2)
    gone = {"walks": ("stream_exposed_ms.lora_train",
                      "walk_idle_ms.lora_train"),
            "side": ("lora_side_ms.lora_train",),
            "fetch": ("stream_exposed_ms.lora_train",),
            "device": NEW[1:]}[absent]
    for name in gone:
        assert _reader(name).read(ctx) is None, name


def test_a_parents_trace_reads_no_new_metric():
    # the parent's trainer opens the copy's span but none of the LoRA's
    t = _step()
    t.spans = [s for s in t.spans if not s.name.startswith("more4d.lora.")]
    ctx = SimpleNamespace(trace=t, trace_units=2)
    for name in NEW[1:]:
        assert _reader(name).read(ctx) is None, name


def test_the_step_count_at_the_cells_size():
    # the forward 3.13e14; the backward's own work and the side path
    # 4.32e14 more
    _, cfg, _, _, _ = harness.cell(CELL)
    assert lora.step_flops(cfg) == pytest.approx(7.453e14, rel=1e-3)
    assert _reader("mfu.lora_train").read(SimpleNamespace(
        cfg=cfg, units=2, window_s=2 * 7.453e14 / 989e12)) == \
        pytest.approx(100.0, rel=1e-3)


def test_a_traced_run_on_the_cpu_reads_no_device_metric(tiny_limits):
    # on the CPU nothing runs on a device: the device readers leave their
    # metrics out; mfu reads the host's window
    rc, res, _ = run_cell(CELL, trace=1, seconds=0.2)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"mfu.lora_train"}


@pytest.mark.cuda
def test_the_dropped_side_path_fails_the_limits_at_the_cells_size(
        monkeypatch):
    """The cell at its own size on the card (~5 min) with the side path
    dropped: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    _side_path_dropped(monkeypatch)
    out = io.StringIO()
    args = SimpleNamespace(workload=CELL, seed=2 ** 33 + 7, seconds=5,
                           trace=0)
    assert harness.run(args, time.perf_counter(), out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    print(res["check"])
    assert not res["correct"], res["check"]
