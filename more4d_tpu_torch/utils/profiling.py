"""Timing and tracing (PyTorch port of ``more4d_tpu/utils/profiling.py``):
wall time per call with the device synchronised, and a ``torch.profiler``
trace (CPU, and the card's kernels when CUDA is there) written as a Chrome
trace, viewable in Perfetto or TensorBoard.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timer(label: Optional[str] = None, sync: bool = True):
    """Decorator printing the wall time of each call, the device
    synchronised after it."""

    def deco(fn):
        name = label or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                _sync()
            print(f"[timer] {name}: {time.perf_counter() - t0:.3f}s")
            return out

        return wrapper

    return deco


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): ...`` writes ``dir/trace_<pid>_<n>.json``, a
    ``torch.profiler`` capture of the block."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))
