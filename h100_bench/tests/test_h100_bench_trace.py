"""The trace arithmetic on synthetic profiler traces: the idle share from
the union of device intervals, attribution by the launching span that
survives a renamed kernel, and the metric readers on top."""

from types import SimpleNamespace

import pytest

from h100_bench import harness
from h100_bench.yardstick import trace as tr

ROOT = harness.ROOT


def _trace(acts, spans):
    """acts: (name, start, end, launch ts, tid); spans: (name, start, end,
    tid). The window is [0, 1000]."""
    activities, launches = [], {}
    for corr, (name, s, e, ts, tid) in enumerate(acts, 1):
        activities.append(tr.Activity(name, s, e, corr,
                                      not name.startswith("Memcpy")))
        launches[corr] = (ts, tid)
    sp = [tr.Span(tr.WINDOW, 0, 1000, 1)] + [tr.Span(*s) for s in spans]
    return tr.Trace(activities, launches, sp)


def test_union_counts_overlap_once_and_clips_to_the_window():
    assert tr.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert tr.union_ns([(-5, 10), (990, 1200)], clip=(0, 1000)) == 20


def test_idle_share_from_the_union_not_the_sum():
    # two streams overlap on [100, 300]: a sum of kernel times would say
    # 500 ns busy, the union says 400
    t = _trace([("k_a", 100, 400, 50, 1), ("k_b", 100, 300, 60, 1),
                ("Memcpy HtoD", 600, 700, 70, 1)], [])
    assert tr.busy_ns(t) == 400
    ctx = SimpleNamespace(device_trace=t, device_units=1)
    reader = harness.load_file(ROOT / "h100_bench" / "metrics" /
                               "idle_share.denoise.py", "idle")
    assert reader.read(ctx) == pytest.approx(60.0)
    gaps = tr.idle_gaps(t)
    assert gaps == [(0, 100), (400, 600), (700, 1000)]
    # a trace of the device alone has no window span: the window is its
    # activities' extent, [100, 700]
    t.spans = []
    assert reader.read(ctx) == pytest.approx(100.0 * 200 / 600)


def test_attribution_follows_the_launch_not_the_name():
    spans = [("h100_bench.attn", 10, 20, 1), ("h100_bench.attn", 40, 50, 1),
             ("aten::mul", 60, 70, 1), ("h100_bench.attn", 80, 90, 2)]
    acts = [("flash_fwd_kernel", 100, 200, 15, 1),       # in span 1
            ("a_renamed_kernel", 200, 260, 45, 1),       # in span 2
            ("flash_fwd_kernel", 300, 350, 65, 1),       # under aten::mul
            ("flash_fwd_kernel", 400, 450, 85, 7),       # a span's time,
            ("flash_fwd_kernel", 500, 550, 95, 2)]       # thread apart
    t = _trace(acts, spans)
    got = [(a.name, a.start) for a in t.attributed("h100_bench.attn")]
    assert got == [("flash_fwd_kernel", 100), ("a_renamed_kernel", 200),
                   ("flash_fwd_kernel", 400)]
    # a kernel whose launch the trace lacks is attributed to nothing
    t.launches.pop(1)
    assert [a.start for a in t.attributed("h100_bench.attn")] == [200, 400]
    assert t.launch_report(["flash_fwd"]) == {"flash_fwd": (4, 3)}


def test_roofline_reader_reads_the_attributed_time():
    import json

    cfg = json.loads((ROOT / "h100_bench/configs/more4d-1.3b.json")
                     .read_text())
    from h100_bench.yardstick import counts

    bound = sum(counts.bound_s(*counts.attn_fwd_work(*c))
                for c in counts.attention_calls(cfg, batch=2))
    # one step whose attention kernels take twice the bound
    dur = int(2 * bound * 1e9)
    t = tr.Trace([tr.Activity("renamed", 0, dur, 1, True),
                  tr.Activity("gemm", dur, dur + 10, 2, True)],
                 {1: (5, 1), 2: (6, 1)},
                 [tr.Span(tr.WINDOW, 0, dur + 10, 1),
                  tr.Span("h100_bench.attn", 4, 5, 1)])
    reader = harness.load_file(ROOT / "h100_bench" / "metrics" /
                               "attn_fwd_roofline.denoise.py", "r")
    ctx = SimpleNamespace(cfg=cfg, trace=t, trace_units=1)
    assert reader.read(ctx) == pytest.approx(50.0, rel=1e-6)
    # nothing launched under the span: the reader gives nothing
    t.spans = t.spans[:1]
    assert reader.read(ctx) is None


def test_kind_readers_and_breakdown():
    t = _trace([("void at::native::elementwise_kernel<Mul>", 0, 100, 1, 1),
                ("multi_tensor_apply_kernel<Adam>", 100, 150, 2, 1),
                ("sm90_xmma_gemm", 200, 500, 3, 1)],
               [("aten::mm", 150, 400, 1), ("aten::add", 600, 620, 1)])
    ctx = SimpleNamespace(device_trace=t, device_units=2)
    eager = harness.load_file(ROOT / "h100_bench/metrics/eager_ms.train.py",
                              "e")
    optim = harness.load_file(ROOT / "h100_bench/metrics/optim_ms.train.py",
                              "o")
    assert eager.read(ctx) == pytest.approx(100 / 1e6 / 2)
    assert optim.read(ctx) == pytest.approx(50 / 1e6 / 2)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["sm90_xmma_gemm", 300 / 1e9]
    # the gap [150, 200] lies under aten::mm, [500, 1000] mostly not
    names = dict(b["idle_gaps"])
    assert names["aten::mm"] == pytest.approx(50 / 1e9)
    assert names[tr.WINDOW] == pytest.approx(500 / 1e9)


@pytest.mark.parametrize("node", [
    "GeneratedBackwardFor_more4d_torch_flash_attn_defaultBackward",
    "autograd::engine::evaluate_function: "
    "GeneratedBackwardFor_more4d_torch_flash_attn_defaultBackward"])
def test_backward_roofline_reads_the_ops_autograd_node(node):
    import json

    cfg = json.loads((ROOT / "h100_bench/configs/more4d-1.3b.json")
                     .read_text())
    from h100_bench.yardstick import counts

    bound = sum(counts.bound_s(*counts.attn_bwd_work(*c))
                for c in counts.attention_calls(cfg, batch=1))
    dur = int(4 * bound * 1e9)
    # the node's span on the autograd engine's thread (7); the op's
    # forward span and a kernel launched outside the node are not read
    t = tr.Trace([tr.Activity("renamed_dkv", 0, dur, 1, True),
                  tr.Activity("flash_fwd", dur, dur + 50, 2, True),
                  tr.Activity("elementwise", dur + 50, dur + 60, 3, True)],
                 {1: (5, 7), 2: (15, 1), 3: (25, 7)},
                 [tr.Span(tr.WINDOW, 0, dur + 60, 1),
                  tr.Span(node, 4, 6, 7),
                  tr.Span("more4d_torch::flash_attn", 14, 16, 1),
                  tr.Span("GeneratedBackwardFor_more4d_torch_flash_attn_"
                          "default", 13, 17, 1)])
    reader = harness.load_file(ROOT / "h100_bench" / "metrics" /
                               "attn_bwd_roofline.train.py", "b")
    ctx = SimpleNamespace(cfg=cfg, trace=t, trace_units=1)
    assert reader.read(ctx) == pytest.approx(25.0, rel=1e-6)
    t.spans = t.spans[:1]
    assert reader.read(ctx) is None
