"""The readers of the program's own spans (``yardstick/spans.py`` and the
metrics on it) on hand-made traces: idle time inside and outside a union
of spans on any thread, the update's device time and kernel count, the
attention roofline read under the program's span, and nothing read where
the program has no span."""

import json
from types import SimpleNamespace

import pytest

from h100_bench import harness
from h100_bench.yardstick import spans as sp
from h100_bench.yardstick import trace as tr

ROOT = harness.ROOT
NEW = ("attn_span_roofline.denoise", "dit_idle_ms.denoise",
       "loop_idle_ms.denoise", "fwd_bwd_idle_ms.train", "update_ms.train",
       "update_idle_ms.train", "update_launches.train")


def _reader(name):
    return harness.load_file(ROOT / "h100_bench" / "metrics" / f"{name}.py",
                             "m_" + name.replace(".", "_"))


def _trace(acts, spans, window=1000):
    """acts: (name, start, end, launch ts, tid); spans: (name, start, end,
    tid). The window is [0, window]."""
    activities, launches = [], {}
    for corr, (name, s, e, ts, tid) in enumerate(acts, 1):
        activities.append(tr.Activity(name, s, e, corr,
                                      not name.startswith("Memcpy")))
        launches[corr] = (ts, tid)
    sp_ = [tr.Span(tr.WINDOW, 0, window, 1)] + [tr.Span(*s) for s in spans]
    return tr.Trace(activities, launches, sp_)


def _denoise_step():
    """One denoise step: the request's span on the main thread (1), the
    DiT's on it too, the launches on another thread (9)."""
    acts = [("k_embed", 120, 150, 110, 9),        # idle [100, 120] in embed
            ("k_block", 180, 400, 170, 9),        # idle [150, 180]: backbone
            ("k_head", 420, 500, 410, 9),         # idle [400, 420]: finalize
            ("k_euler", 560, 600, 550, 9)]        # idle [500, 560]: the loop
    spans = [("more4d.denoise", 50, 700, 1),      # idle [50, 100], [600, 700]
             ("more4d.dit.embed", 100, 160, 1),
             ("more4d.dit.backbone", 160, 400, 1),
             ("more4d.dit.finalize", 400, 500, 1)]
    return _trace(acts, spans)


def test_interval_arithmetic():
    assert sp.intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10),
                                                            (20, 25)]
    assert sp.intersect([(0, 10)], [(10, 20)]) == []
    t = _trace([("k", 0, 10, 0, 1)],
               [("more4d.a", -50, 20, 1), ("more4d.b", 10, 40, 2),
                ("more4d.a", 900, 1200, 1), ("other", 0, 1000, 1)])
    # merged across threads, clipped to the window
    assert sp.union(t, ("more4d.a", "more4d.b")) == [(0, 40), (900, 1000)]
    assert sp.union(t, "more4d.b") == [(10, 40)]
    assert sp.union(t, ("other", "more4d.b")) == [(0, 1000)]


def test_idle_inside_and_outside_a_union_of_spans_on_any_thread():
    t = _denoise_step()
    # the DiT's spans: [100, 500]; the device idle in it 20 + 30 + 20
    assert sp.idle_ns(t, sp.DIT) == 70
    # inside the request, outside the DiT: [50, 100], [500, 560], [600, 700]
    assert sp.idle_ns(t, sp.REQUEST, outside=sp.DIT) == 210
    ctx = SimpleNamespace(trace=t, trace_units=2)
    assert _reader("dit_idle_ms.denoise").read(ctx) == pytest.approx(
        70 / 1e6 / 2)
    assert _reader("loop_idle_ms.denoise").read(ctx) == pytest.approx(
        210 / 1e6 / 2)
    # the two together never exceed the window's idle: [0, 120], [150,
    # 180], [400, 420], [500, 560], [600, 1000]
    whole = sum(e - s for s, e in tr.idle_gaps(t))
    assert whole == 630 and 70 + 210 <= whole


def test_train_readers_split_the_step_by_phase():
    # forward and clamp on the main thread (1); the backward's kernels
    # launched by autograd's thread (7) inside the main thread's span
    acts = [("gemm", 10, 100, 5, 1),                  # forward
            ("flash_bwd_dq", 130, 300, 120, 7),       # backward
            ("reduce_kernel", 320, 330, 310, 1),      # clamp
            ("Memcpy DtoH", 340, 345, 335, 1),        # clamp: loss.item()
            ("multi_tensor_apply<Adam>", 400, 450, 390, 1),  # optimizer
            ("multi_tensor_apply<Mul>", 470, 480, 460, 1),   # ema
            ("randn", 600, 610, 590, 1)]              # the driver's draw
    spans = [("more4d.train.forward", 0, 110, 1),
             ("more4d.train.backward", 110, 305, 1),
             ("autograd::engine::evaluate_function: X", 115, 300, 7),
             ("more4d.train.clamp", 305, 350, 1),
             ("more4d.train.optimizer", 350, 455, 1),
             ("more4d.train.ema", 455, 490, 1)]
    t = _trace(acts, spans)
    ctx = SimpleNamespace(trace=t, trace_units=1)
    # idle in [0, 110]: [0, 10], [100, 110]; in [110, 305]: [110, 130],
    # [300, 305]
    assert _reader("fwd_bwd_idle_ms.train").read(ctx) == pytest.approx(
        45 / 1e6)
    # update [305, 490]: idle [305, 320], [330, 340], [345, 400], [450,
    # 470], [480, 490]
    assert _reader("update_idle_ms.train").read(ctx) == pytest.approx(
        110 / 1e6)
    # device time of everything launched in the update, the copy included
    assert _reader("update_ms.train").read(ctx) == pytest.approx(
        (10 + 5 + 50 + 10) / 1e6)
    # kernels, not copies: the reduce, Adam and the EMA
    assert _reader("update_launches.train").read(ctx) == 3
    ctx.trace_units = 3
    assert _reader("update_launches.train").read(ctx) == 1


def test_the_twin_roofline_equals_the_outside_reader():
    cfg = json.loads((ROOT / "h100_bench/configs/more4d-1.3b.json")
                     .read_text())
    # the benchmark's span around the entry wraps the program's, both
    # around the same launches; a kernel outside both is read by neither
    acts = [("flash_fwd_kernel", 0, 3_000_000, 15, 1),
            ("a_renamed_kernel", 3_000_000, 4_000_000, 45, 1),
            ("gemm", 4_000_000, 9_000_000, 65, 1)]
    spans = [("h100_bench.attn", 10, 20, 1), ("more4d.attn", 11, 19, 1),
             ("h100_bench.attn", 40, 50, 1), ("more4d.attn", 41, 49, 1)]
    t = _trace(acts, spans, window=10_000_000)
    ctx = SimpleNamespace(cfg=cfg, trace=t, trace_units=1)
    twin = _reader("attn_span_roofline.denoise").read(ctx)
    outside = _reader("attn_fwd_roofline.denoise").read(ctx)
    assert twin is not None and twin == pytest.approx(outside, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_nothing_without_its_spans(name):
    cfg = json.loads((ROOT / "h100_bench/configs/more4d-1.3b.json")
                     .read_text())
    # a parent's trace: kernels and the benchmark's own spans, no program
    # span at all
    acts = [("flash_fwd_kernel", 0, 100, 15, 1),
            ("multi_tensor_apply<Adam>", 200, 300, 150, 1)]
    spans = [("h100_bench.attn", 10, 20, 1), ("aten::mm", 140, 160, 1)]
    ctx = SimpleNamespace(cfg=cfg, trace=_trace(acts, spans), trace_units=2)
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_nothing_without_device_activity(name):
    # the host traced alone (the CPU stand-in): the spans are there, the
    # device is not
    cfg = json.loads((ROOT / "h100_bench/configs/more4d-1.3b.json")
                     .read_text())
    spans = [(n, 100 * i, 100 * i + 50, 1) for i, n in enumerate((
        "more4d.denoise", "more4d.dit.embed", "more4d.attn",
        "more4d.train.forward", "more4d.train.backward",
        "more4d.train.clamp", "more4d.train.optimizer",
        "more4d.train.ema"))]
    ctx = SimpleNamespace(cfg=cfg, trace=_trace([], spans), trace_units=2)
    assert _reader(name).read(ctx) is None


def test_every_new_metric_is_listed_for_its_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        cell = name.rsplit(".", 1)[1]
        assert all(w.endswith("." + f"straag_{cell}") for w in m["workloads"])
        assert m["source"] == "device_trace"
