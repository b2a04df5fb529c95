"""A tiny configuration, a CPU stand-in for the card, and a whole run of
a cell through ``harness.run`` on them."""

from __future__ import annotations

import io
import json
import time
from types import SimpleNamespace

import torch

TINY = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2, text_len=8,
            text_dim=16, clip_dim=16, clip_tokens=5, motion_feature_dim=8,
            mpm_tokens=16, num_frames=5, height=32, width=32, freq_dim=16,
            sample_steps=3)
CELLS = ("more4d-1.3b.straag_denoise", "more4d-14b-fp8.straag_denoise",
         "more4d-1.3b.straag_train")


class CpuCard:
    """Runs a cell on the CPU: the harness's look for a chip skipped."""

    device = torch.device("cpu")
    kind = "cpu stand-in"

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 0

    def device_activities(self):
        from torch.profiler import ProfilerActivity

        # no device here: the host's activities stand in
        return [ProfilerActivity.CPU]

    def build(self):
        pass


def run_cell(workload, seed=2 ** 33 + 5, seconds=0.01, trace=0,
             cfg_update=TINY):
    """(exit code, the result line as a dict, standard error)."""
    from h100_bench import harness

    out, err = io.StringIO(), io.StringIO()
    args = SimpleNamespace(workload=workload, seed=seed, seconds=seconds,
                           trace=trace)
    rc = harness.run(args, time.perf_counter(), out=out, err=err,
                     card=CpuCard(), cfg_update=dict(cfg_update))
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), err.getvalue()
