"""The harness finds every cell's pieces by name, and refuses to give a
result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_config_traffic_driver_and_metrics(w):
    entry, cfg, traffic, e2e, layer = harness.cell(w)
    assert cfg["name"] == entry["config"]
    driver = harness.load_file(
        ROOT / "h100_bench" / "drivers" / f"{traffic['driver']}.py", "d")
    assert callable(driver.setup)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    for m in layer:
        reader = harness.load_file(
            ROOT / "h100_bench" / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)
        assert m["moves"] in names


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "more4d-1.3b.straag_denoise", "--seed", str(2 ** 33 + 1),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no result" in r.stderr


def test_run_beside_no_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "more4d_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    found = harness.forbidden_modules()
    assert "jaxlib.fake" in found
    assert not any(n.startswith("more4d_tpu_torch") for n in found)


@pytest.mark.parametrize("seconds,tail", [(0.0, 3), (0.05, 3), (0.05, 0)])
def test_measure_ends_on_the_checked_tail_with_the_clock_stopped(seconds,
                                                                tail):
    import time

    calls = []

    class Sess:
        def run_one(self):
            calls.append("step")
            time.sleep(0.005)
            return 1

        def hold(self, i):
            calls.append(i)
            time.sleep(0.05)

    window_s, units, each = harness.measure(Sess(), seconds, lambda: None,
                                            tail)
    assert units == len(each) == calls.count("step")
    if tail:
        # the window ends on exactly ``tail`` steps, a hold before each and
        # one after the last
        assert calls[calls.index(0):] == [0, "step", 1, "step", 2, "step", 3]
        # the holds' 0.2 s are not the window's; it ends within a step of
        # ``seconds``
        assert seconds - 0.01 <= window_s < seconds + 0.04
    else:
        assert all(c == "step" for c in calls)
        assert window_s >= seconds
