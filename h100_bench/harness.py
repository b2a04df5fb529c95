"""What every cell's run does, whatever its driver: find the cell, its
configuration and traffic by name; set up the driver; measure the window;
read the per-layer metrics from the trace; check the outputs; print the
result line.

A run measures for ``--seconds`` in a closed loop: requests start while
the window is open, and the window closes when the last one started has
completed, so every unit of work counted lies inside it. With
``--trace 1`` two more windows follow the measured one, each as long:
one under ``torch.profiler`` tracing the device alone (what ran there and
when), one tracing the host too (which host operation launched each
kernel), and the result carries the per-layer metrics in place of the
end-to-end ones.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "more4d_tpu")
ATTN = "h100_bench.attn"


class NoResult(Exception):
    """A run that must exit non-zero and print no result."""


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise NoResult(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str):
    """(the workload's entry, its configuration entry and file, its
    traffic file, the end-to-end and per-layer metric entries it
    reports)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        w = next(x for x in bench["workloads"] if x["name"] == workload)
    except StopIteration:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    cfg = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{workload}.json").read_text())

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return w, cfg, traffic, e2e, layer


def forbidden_modules():
    """The loaded modules whose top-level name is a forbidden one (the
    whole name before the first dot)."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".", 1)[0] in FORBIDDEN})


@contextlib.contextmanager
def forward_span():
    """The benchmark's span around the DiT's attention entry
    (``nn/attention.py flash_attention``). Without a gradient the entry
    launches K1 itself, not through the op ``more4d_torch::flash_attn``,
    so a denoise step has no span of the program's own around its
    attention; the backward's time is read under the op's autograd node
    (``metrics/attn_bwd_roofline.train.py``)."""
    import importlib

    import torch

    # the package exports a function named ``attention`` too: take the
    # module itself
    na = importlib.import_module("more4d_tpu_torch.nn.attention")
    fwd = na.flash_attention

    def fwd_span(*a, **kw):
        with torch.profiler.record_function(ATTN):
            return fwd(*a, **kw)
    na.flash_attention = fwd_span
    try:
        yield
    finally:
        na.flash_attention = fwd


def measure(sess, seconds: float, sync, tail: int = 0):
    """(window seconds, units completed, each request's seconds): requests
    start while fewer than ``seconds`` have passed; the window closes when
    the last completes.

    With ``tail`` the window ends on ``tail`` units whose work the check
    follows: once the units so far, at their median pace, leave room for
    no more than ``tail``, exactly ``tail`` more run. Before each of them
    and after the last, ``sess.hold(i)`` keeps what the check compares
    while the clock stands still, so the window's time is its units'
    alone."""
    units, each, held = 0, [], 0.0
    t0 = time.perf_counter()

    def one():
        nonlocal units
        t1 = time.perf_counter()
        units += sess.run_one()
        each.append(time.perf_counter() - t1)

    def hold(i):
        nonlocal held
        sync()
        t1 = time.perf_counter()
        sess.hold(i)
        held += time.perf_counter() - t1

    while True:
        elapsed = time.perf_counter() - t0 - held
        pace = statistics.median(each) if each else 0.0
        if tail and elapsed + tail * pace >= seconds:
            for i in range(tail):
                hold(i)
                one()
            hold(tail)
            break
        if elapsed >= seconds:
            break
        one()
    sync()
    return time.perf_counter() - t0 - held, units, each


def launches():
    from more4d_tpu_torch.kernels import flash_attention as fa

    return {"K1": fa.flash_attention_cuda.launches,
            "K2": fa.flash_bwd_dq_cuda.launches,
            "K3": fa.flash_bwd_dkv_cuda.launches}


class Card:
    """The CUDA device the run measures."""

    def __init__(self, chips: int):
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            raise NoResult(f"the cell needs {chips} CUDA device(s); torch "
                           f"sees {torch.cuda.device_count()}")
        self.device = torch.device("cuda", 0)
        self.kind = torch.cuda.get_device_name(0)

    def sync(self):
        import torch

        torch.cuda.synchronize(self.device)

    def reset_peak(self):
        import torch

        torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated(self.device))

    def device_activities(self):
        """What the profiler traces of the device alone."""
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA]

    def build(self):
        from more4d_tpu_torch.kernels import _build

        _build.build_all()


def run(args, t_start: float, out=sys.stdout, err=sys.stderr, card=None,
        cfg_update=None) -> int:
    """One run of ``args.workload``. ``card`` is the device to measure (the
    CUDA card by default; the tests pass a stand-in that runs on the CPU);
    ``cfg_update`` changes sizes of the configuration (the tests' tiny
    one)."""
    w, cfg, traffic, e2e, layer = cell(args.workload)
    cfg.update(cfg_update or {})
    card = card or Card(w["chips"])
    device = card.device
    card.build()
    driver = load_file(HERE / "drivers" / f"{traffic['driver']}.py",
                       f"h100_bench_driver_{traffic['driver']}")
    sess = driver.setup(cfg, traffic, args.seed, device)
    # set-up's objects out of the collector's way: a full collection no
    # longer walks the model's module tree in the window
    gc.collect()
    gc.freeze()
    card.sync()
    setup_s = time.perf_counter() - t_start

    card.reset_peak()
    before = launches()
    sync = card.sync
    traced_units = 0            # the profiled windows' units together
    window_s, units, each = measure(sess, args.seconds, sync,
                                    getattr(sess, "tail", 0))
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from h100_bench.yardstick.trace import WINDOW, Trace

        # two more windows under the profiler: the device's own metrics
        # from one that traces the device alone, the attribution to host
        # operations from one that traces the host too (which slows a
        # host-bound step); the host-clock ones (mfu) from the untraced
        # window above
        with profile(activities=card.device_activities()) as prof:
            # the span is traced where the host is (the CPU stand-in);
            # on the card the window is the device activities' extent
            with record_function(WINDOW):
                device_s, device_units, _ = measure(sess, args.seconds, sync)
        t_read = time.perf_counter()
        device_trace = Trace.from_profiler(prof)
        read_s = time.perf_counter() - t_read
        with forward_span(), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) \
                as prof:
            with record_function(WINDOW):
                traced_s, host_units, _ = measure(sess, args.seconds, sync)
        t_read = time.perf_counter()
        trace = Trace.from_profiler(prof)
        read_s += time.perf_counter() - t_read
        del prof
        traced_units = device_units + host_units
    counts = {k: v - before[k] for k, v in launches().items()}
    device_info = {"platform": "gpu", "kind": card.kind,
                   "count": w["chips"], "memory_peak_bytes": card.peak()}
    rates = sess.end_to_end(window_s, units) if units else {}
    per_unit = {k: v / max(units + traced_units, 1)
                for k, v in counts.items()}
    print(f"window {window_s:.3f} s, {units} {sess.unit}s, "
          f"{sess.attempted} attempted, kernel launches {counts} "
          f"({per_unit} a {sess.unit}), rates {rates}; a request's "
          f"seconds: min "
          f"{min(each):.4f}, median {sorted(each)[len(each) // 2]:.4f}, max "
          f"{max(each):.4f}", file=err)

    result = {"correct": False, "attempted": sess.attempted, "failed": 0,
              "metrics": {}, "device": device_info}
    if args.trace:
        from h100_bench.yardstick.trace import breakdown, busy_ns

        lo, hi = device_trace.window()
        device_info["busy_s"] = busy_ns(device_trace) / 1e9
        device_info["window_s"] = (hi - lo) / 1e9
        ctx = SimpleNamespace(cfg=cfg, traffic=traffic, window_s=window_s,
                              units=units, device_trace=device_trace,
                              device_units=device_units, trace=trace,
                              trace_units=host_units)
        for m in layer:
            reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                               "h100_bench_metric_" + m["name"].replace(
                                   ".", "_"))
            value = reader.read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = {
            "device_ops": breakdown(device_trace)["device_ops"],
            "idle_gaps": breakdown(trace)["idle_gaps"]}
        from h100_bench.yardstick.kinds import PORT_KERNELS

        def rate(s, n):
            return sess.end_to_end(s, n) if n else {}
        print(f"traces read in {read_s:.1f} s; "
              f"device-only window {device_s:.3f} s, {device_units} "
              f"{sess.unit}s, rates {rate(device_s, device_units)}; host "
              f"and device window {traced_s:.3f} s, {host_units} "
              f"{sess.unit}s, rates {rate(traced_s, host_units)}; port "
              f"kernels (in the window, launch known): "
              f"{trace.launch_report([n for n, _ in PORT_KERNELS])}", file=err)
        del trace, device_trace, ctx
    else:
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else rates.get(m["name"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}

    sess.release()
    t_check = time.perf_counter()
    checks = sess.verify()
    result["failed"] = sess.failed
    for line in getattr(sess, "notes", list)():
        print(line, file=err)
    print(f"check took {time.perf_counter() - t_check:.1f} s", file=err)
    found = forbidden_modules()
    if found:
        raise NoResult(f"loaded in this process: {found}")
    result["correct"] = bool(units > 0 and sess.failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks))
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    return 0
