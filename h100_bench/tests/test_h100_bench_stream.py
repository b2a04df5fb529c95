"""The streamed 14B's cell (``more4d-14b-stream.straag_denoise``, driver
``denoise_stream``) at a tiny configuration on the CPU: a whole run is
correct against the plain reference, the fp8 control reads wider, a broken
timed path is not correct; and the readers of the streamed walk's copies
on hand-made traces, reading nothing where the program has no such span
or copy."""

import math
from types import SimpleNamespace

import pytest
import torch

from _tiny import TINY, run_cell
from test_h100_bench_drivers import (TINY_LIMITS, _unchanged_step,  # noqa: F401
                                     tiny_limits)
from h100_bench import harness, inputs
from h100_bench.reference.dit import CONTROLS
from h100_bench.yardstick import stream
from h100_bench.yardstick import trace as tr

CELL = "more4d-14b-stream.straag_denoise"
ROOT = harness.ROOT
BLOCK = 1000          # a hand-made trace's block bytes
COPY = "Memcpy HtoD (Pinned -> Device)"


def _reader(name):
    return harness.load_file(ROOT / "h100_bench" / "metrics" / f"{name}.py",
                             "m_" + name.replace(".", "_"))


def test_a_whole_run_is_correct_against_the_reference(tiny_limits):
    rc, res, err = run_cell(CELL)
    assert rc == 0
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "denoise_step_s"}


def test_the_timed_path_is_the_clis_streamed_loop(monkeypatch):
    from more4d_tpu_torch.models.wan_dit import WanDiT
    from more4d_tpu_torch.parallel.offload import StreamedDiT

    calls = []
    loop, walk = StreamedDiT.denoise, WanDiT.backbone
    monkeypatch.setattr(StreamedDiT, "denoise", lambda self, *a, **kw: (
        calls.append("streamed"), loop(self, *a, **kw))[1])
    monkeypatch.setattr(WanDiT, "backbone", lambda self, it: (
        calls.append("resident"), walk(self, it))[1])
    rc, res, _ = run_cell(CELL)
    assert rc == 0 and calls and set(calls) == {"streamed"}


def test_the_fp8_control_reads_wider_than_the_program():
    w, cfg, traffic, _, _ = harness.cell(CELL)
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
        assert ctl["latent_gap"] > 2 * mine["latent_gap"], (mine, ctl)
        assert ctl["latent_gap"] > TINY_LIMITS["latent_gap"]


def _skipped_block(monkeypatch):
    # the walk's last block left out: its weights never reach the stack
    from more4d_tpu_torch.parallel.offload import StreamedDiT

    enter = StreamedDiT._enter

    def skip_last(self, k):
        blk = enter(self, k)
        if k == len(self.host_blocks) - 1:
            return lambda x, *a: x
        return blk
    monkeypatch.setattr(StreamedDiT, "_enter", skip_last)


@pytest.mark.parametrize("fault", [_unchanged_step, _skipped_block],
                         ids=["unchanged_step", "skipped_block"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, tiny_limits):
    fault(monkeypatch)
    rc, res, _ = run_cell(CELL)
    assert rc == 0
    assert not res["correct"], res["check"]


def test_block_bytes_is_the_programs_host_buffer():
    from h100_bench.drivers import denoise_stream

    w, cfg, _, _, _ = harness.cell(CELL)
    cfg.update(TINY)
    _, host = denoise_stream.build_streamed(cfg, 5, torch.device("cpu"))
    assert {hb.flat.numel() for hb in host} == {stream.block_bytes(cfg)}
    # the 14B's: 419.6e6 parameters a block, 16.79e9 bytes a walk
    _, cfg14, _, _, _ = harness.cell(CELL)
    assert sum(math.prod(s) for _, s, _, _ in
               inputs.block_spec(cfg14)) == 419_597_824
    assert 40 * stream.block_bytes(cfg14) == 16_790_609_920


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


def _walk():
    """Two blocks: block 0's copy [100, 200] with nothing to hide it,
    block 1's [210, 300] under block 0's kernel [200, 290] but its last 10;
    a copy launched outside any fetch span and a kernel's own copy."""
    acts = [(COPY, 100, 200, 15),
            (COPY, 210, 300, 25),
            ("k_block0", 200, 290, 30),
            ("k_block1", 300, 400, 40),
            (COPY, 500, 600, 450),                # outside the walk's fetch
            ("Memcpy DtoD (Device -> Device)", 410, 420, 35)]
    spans = [("more4d.dit.backbone", 10, 45),
             ("more4d.stream.fetch", 12, 16),
             ("more4d.stream.fetch", 22, 26)]
    return _trace(acts, spans)


def test_the_readers_on_a_hand_made_walk(monkeypatch):
    monkeypatch.setattr(stream, "block_bytes", lambda cfg: BLOCK)
    ctx = SimpleNamespace(trace=_walk(), trace_units=2, cfg={})
    # the two fetched copies: 2 x 1000 bytes in 190 ns
    share = _reader("stream_h2d_share.denoise").read(ctx)
    assert share == pytest.approx(100 * 2 * BLOCK / 190e-9
                                  / stream.H2D_BYTES_PER_S)
    # exposed: [100, 200] and [290, 300], over 2 steps
    exposed = _reader("stream_exposed_ms.denoise").read(ctx)
    assert exposed == pytest.approx(110 / 1e6 / 2)


@pytest.mark.parametrize("absent", ["fetch", "backbone", "copies",
                                    "device"])
def test_the_readers_read_nothing_where_the_program_has_no_such_thing(
        absent, monkeypatch):
    monkeypatch.setattr(stream, "block_bytes", lambda cfg: BLOCK)
    t = _walk()
    if absent == "fetch":           # the parent's walk: no fetch span
        t.spans = [s for s in t.spans if s.name != "more4d.stream.fetch"]
    elif absent == "backbone":      # copies fetched outside any walk
        t.spans = [s for s in t.spans if s.name != "more4d.dit.backbone"]
    elif absent == "copies":        # a walk that copied nothing (the CPU)
        t.activities = [a for a in t.activities if a.name != COPY]
    else:                           # a trace of the host alone
        t.activities = []
    ctx = SimpleNamespace(trace=t, trace_units=2, cfg={})
    for name in ("stream_h2d_share.denoise", "stream_exposed_ms.denoise"):
        assert _reader(name).read(ctx) is None, name


def test_a_traced_run_on_the_cpu_reads_no_copy(tiny_limits):
    # on the CPU nothing is copied: the new readers leave their metrics
    # out; mfu reads the host's window
    rc, res, _ = run_cell(CELL, trace=1, seconds=0.2)
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"mfu.denoise"}
