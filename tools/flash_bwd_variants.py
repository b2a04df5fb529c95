"""K2 and K3 (``more4d_tpu_torch/csrc/flash_attention_bwd.cu``) built from
edited copies of their sources, to see what bounds them and that the card
tests catch faults. Needs a card and nvcc; run from the root of a checkout:

    python tools/flash_bwd_variants.py time     # what bounds K2 and K3
    python tools/flash_bwd_variants.py faults   # the card tests catch faults

Each variant copies the package (and the card tests) into a temporary
directory and makes its edits there (pairs of source text and its
replacement, each of which must be found); the checkout is not touched.

``time`` times K2 and K3 with CUDA events at the training path's shapes,
the self-attention [1, 9568, 12, 128] and the text cross-attention (512
keys), as they are and with parts of their work taken out (``TIMINGS``).
Those variants are wrong by design; only their times mean anything. The
unedited kernels run first and last, to show the spread between runs.

``faults`` plants each fault of ``FAULTS`` in turn and runs the backward's
card tests on the copy (``pytest -m cuda -k backward``): each fault must
fail them, and the unedited copy must pass them.

Prints one line a variant, the card's name and power limit, and a JSON
object last; exits non-zero if a variant did not do what it must.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BWD = "more4d_tpu_torch/csrc/flash_attention_bwd.cu"
SM90 = "more4d_tpu_torch/csrc/flash_sm90.cuh"

_LOADS = [(BWD, "if (kt + 1 < n_tiles) {", "if (false) {"),
          (BWD, "if (qt + 1 < qt1) {", "if (false) {")]
_ELEMENTWISE = [
    (BWD, "const float p = ok ? exp2f(s[e] - lse_r[i]) : 0.f;",
     "const float p = s[e];"),
    (BWD, "const float p = ok ? exp2f(s[e] - cL[col]) : 0.f;",
     "const float p = s[e];")]
_ONE_CTA = [
    (BWD, "const int smem = 6 * BN * D * 2 + 1024;",
     "const int smem = 6 * BN * D * 2 + 1024 + 100000;"),
    (BWD, "const int smem = 6 * BN * D * 2 + 4 * BN * 4 + 1024;",
     "const int smem = 6 * BN * D * 2 + 4 * BN * 4 + 1024 + 100000;")]

TIMINGS = {
    "as is": [],
    "no in-loop loads (each CTA reuses its first tile)": _LOADS,
    "no exp2 or masks (P = S)": _ELEMENTWISE,
    "neither": _LOADS + _ELEMENTWISE,
    "one CTA a SM (shared memory padded)": _ONE_CTA,
    "as is, again": [],
}

FAULTS = {
    "MN-major descriptor: wrong column-block offset": [
        (SM90, "return desc_sw128(tile + kk * 2048, ROWS * 128, 1024);",
         "return desc_sw128(tile + kk * 2048, ROWS * 64, 1024);")],
    "loader without the 128-byte swizzle": [
        (SM90, "(((c & 7) ^ (r & 7)) << 4)", "((c & 7) << 4)")],
    "q-split reduce drops the last split": [
        (BWD, "for (int s = 1; s < splits; ++s) {",
         "for (int s = 1; s < splits - 1; ++s) {")],
    "K2 key mask ignores kv_len": [
        (BWD, "const bool ok = row_ok[i] && k0 + j * 8 + 2 * t + (c & 1) "
              "< kv_len;",
         "const bool ok = row_ok[i] && k0 + j * 8 + 2 * t + (c & 1) < Lk;")],
}

_TIME_CHILD = r"""
import json, torch
from more4d_tpu_torch.kernels.flash_attention import (
    _delta, flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
    scaled_q)

def ms(fn, reps=20):
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

dev, h, d, L = torch.device("cuda"), 12, 128, 9568
g = torch.Generator(dev).manual_seed(3)
out = {}
for name, lk in (("self", L), ("cross_text", 512)):
    q, do = (torch.randn(1, L, h, d, device=dev, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(1, lk, h, d, device=dev, generator=g).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v)
    delta, qp = _delta(o, do), scaled_q(q, d ** -0.5)
    out[name] = dict(
        k2_ms=ms(lambda: flash_bwd_dq_cuda(qp, k, v, None, do, lse, delta)),
        k3_ms=ms(lambda: flash_bwd_dkv_cuda(qp, k, v, None, do, lse, delta)))
print(json.dumps(out))
"""

_TEST_CMD = [sys.executable, "-m", "pytest",
             "tests/test_torch_kernels_cuda.py", "-m", "cuda", "--noconftest", "-q", "-x", "-k", "backward",
             "-p", "no:cacheprovider"]


def apply_edits(root: Path, edits) -> None:
    """Make ``edits`` (file, text, replacement) to the files under
    ``root``; raise if a text is not found."""
    for rel, old, new in edits:
        path = root / rel
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{rel} no longer holds {old!r}")
        path.write_text(text.replace(old, new))


def _copy(edits, workdir: Path) -> dict:
    shutil.copytree(ROOT / "more4d_tpu_torch", workdir / "more4d_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (workdir / "tests").mkdir()
    shutil.copy(ROOT / "tests/test_torch_kernels_cuda.py", workdir / "tests")
    apply_edits(workdir, edits)
    return dict(os.environ, PYTHONPATH=str(workdir))


def time_variant(edits, workdir: Path) -> dict:
    env = _copy(edits, workdir)
    done = subprocess.run([sys.executable, "-c", _TIME_CHILD], cwd=workdir,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"variant failed:\n{done.stdout}\n{done.stderr}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def card_tests(edits, workdir: Path) -> dict:
    env = _copy(edits, workdir)
    done = subprocess.run(_TEST_CMD, cwd=workdir, env=env,
                          capture_output=True, text=True, timeout=900)
    failed = [line for line in done.stdout.splitlines()
              if line.startswith("FAILED")]
    return dict(rc=done.returncode, failed=failed,
                summary=done.stdout.strip().splitlines()[-1:])


def main(argv) -> int:
    import torch

    mode = argv[0] if argv else "time"
    if mode not in ("time", "faults"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA card", file=sys.stderr)
        return 2
    results, ok = {}, True
    variants = (TIMINGS if mode == "time"
                else {"as is": [], **FAULTS})
    for name, edits in variants.items():
        with tempfile.TemporaryDirectory() as tmp:
            if mode == "time":
                results[name] = r = time_variant(edits, Path(tmp))
                for shape, t in r.items():
                    print(f"{name:50s} {shape:10s} K2 {t['k2_ms']:.4f} ms  "
                          f"K3 {t['k3_ms']:.4f} ms", flush=True)
                continue
            results[name] = r = card_tests(edits, Path(tmp))
        want_pass = not edits
        good = (r["rc"] == 0) == want_pass and (want_pass or r["failed"])
        ok &= bool(good)
        print(f"{name:50s} card tests rc {r['rc']} "
              f"({'must pass' if want_pass else 'must fail'}): "
              f"{'as it must' if good else 'NOT AS IT MUST'}; "
              f"{r['failed'] or r['summary']}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps(dict(mode=mode, card=smi, ok=ok, variants=results)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
