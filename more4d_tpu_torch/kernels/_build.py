"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/`` at the
repository root, then loaded with ``ctypes``. A library's file name carries
a hash of its source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source is rebuilt and a current one is reused. ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them together.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")
SOURCES = ("flash_attention", "flash_attention_bwd", "gs_splat", "rownorm",
           "widen")

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def log_path(name: str) -> Path:
    """The ``nvcc`` output (with ``ptxas -v``'s report) of the current
    library for ``csrc/<name>.cu``, kept beside it."""
    return _lib_path(name).with_suffix(".nvcc.log")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source that has no current library, with one
    ``nvcc`` process per source started together. Returns the wall seconds
    of each compile (0.0 where the library was already current). Raises
    with the compiler's output if any compile fails."""
    names = tuple(names or SOURCES)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs, seconds = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        log_path(name).write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """``symbol`` of the library for ``csrc/<name>.cu``, its C signature
    (``argtypes``, an int return) set once on first use."""
    fn = _bound.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _bound[symbol] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
