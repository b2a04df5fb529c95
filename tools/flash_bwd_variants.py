"""The port's kernels built from edited copies of their sources, to see what
bounds them and that the card tests catch faults: K1 (the attention
forward, ``more4d_tpu_torch/csrc/flash_attention.cu``), K2 and K3 (its
backward, ``flash_attention_bwd.cu``), K4 (the splat, ``gs_splat.cu``),
K5 (the row norms, ``rownorm.cu``) and K6 (the fp8 widening,
``widen.cu``; these two faults only). Needs a card and nvcc;
run from the root of a checkout:

    python tools/flash_bwd_variants.py time [WORD]    # what bounds K1-K4
    python tools/flash_bwd_variants.py faults [WORD]  # the card tests catch
                                                      # faults

Each variant copies the package (and the card tests) into a temporary
directory and makes its edits there (pairs of source text and its
replacement, each of which must be found); the checkout is not touched.
The checkout's ``build/`` is copied along, so a library whose sources a
variant leaves alone is not compiled again.

``time`` times K1 at the main path's self-attention [2, 9568, 12, 128] and
text cross-attention (512 keys), K2 and K3 at the training path's
[1, 9568, 12, 128] and its text cross-attention, and K4 over one 49-frame
trajectory of the 368x512 depth lift, with CUDA events, as they are and
with parts of their work taken out or their tiles changed (``TIMINGS``;
with WORD, only the variants whose name holds it). Variants that take work
out are wrong by design; only their times mean anything. The unedited
kernels run first and last, to show the spread between runs.

``faults`` plants each fault of ``FAULTS`` (with WORD, those whose name
holds it) in turn and runs the card tests on the copy (``pytest
tests/test_torch_kernels_cuda.py -m cuda``): each fault must fail them,
and the unedited copy must pass them.

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
FWD = "more4d_tpu_torch/csrc/flash_attention.cu"
BWD = "more4d_tpu_torch/csrc/flash_attention_bwd.cu"
SM90 = "more4d_tpu_torch/csrc/flash_sm90.cuh"
SPLAT = "more4d_tpu_torch/csrc/gs_splat.cu"
ROWNORM = "more4d_tpu_torch/csrc/rownorm.cu"
WIDEN = "more4d_tpu_torch/csrc/widen.cu"

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
    # K2 and K3
    "no in-loop loads (each CTA reuses its first tile)": _LOADS,
    "no exp2 or masks (P = S)": _ELEMENTWISE,
    "neither": _LOADS + _ELEMENTWISE,
    "one CTA a SM (shared memory padded)": _ONE_CTA,
    "K1 no exp2 or masks (P = S)": [
        (FWD, "online_softmax(s, m_row, l_row, alpha, k0, kv_len, t);",
         "alpha[0] = alpha[1] = 1.f;")],
    "K1 O not written": [(FWD, "if (row0 + r < Lq)\n", "if (false)\n")],
    "K1 no ping-pong (turns not taken)": [
        (FWD, "if constexpr (NWG > 1) bar_sync(TURN + wg, 256);", ""),
        (FWD, "if constexpr (NWG > 1) bar_arrive(TURN + 1 - wg, 256);", "")],
    "K1 one item a CTA (not persistent)": [
        (FWD, "const int grid = min(n_items, sms);",
         "const int grid = n_items;")],
    "K1 64-key tiles (4 stages)": [
        (FWD, "constexpr int BK = 128;", "constexpr int BK = 64;"),
        (FWD, "constexpr int NS = 2;", "constexpr int NS = 4;")],
    "K1 64-row tiles (one consumer warpgroup)": [
        (FWD, "constexpr int NWG = 2;", "constexpr int NWG = 1;")],
    "K4 one pixel a thread": [
        (SPLAT, "constexpr int PPT = 4;", "constexpr int PPT = 1;")],
    "K4 two pixels a thread": [
        (SPLAT, "constexpr int PPT = 4;", "constexpr int PPT = 2;")],
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
    "K1 key mask dropped": [
        (FWD, "if (k0 + BK > kv_len) {", "if (false) {")],
    "K1 lse without the max": [
        (FWD, "m_row[i] + log2f(l);", "log2f(l);")],
    "K4 coefficient without the -0.5": [
        (SPLAT, "-0.5f * kLog2e / (sk * sk)", "-kLog2e / (sk * sk)")],
    "K4 last record skipped": [
        (SPLAT, "for (int k = 0; k < n; ++k) {",
         "for (int k = 0; k < n - 1; ++k) {")],
    "K5 the row's last 16-byte chunk not stored": [
        (ROWNORM, "if (c < nc)\n      chunk_epilogue<EPI>(",
         "if (c + 1 < nc)\n      chunk_epilogue<EPI>(")],
    "K5 statistics divided by D - 8": [
        (ROWNORM, "const float inv_d = 1.f / static_cast<float>(D);",
         "const float inv_d = 1.f / static_cast<float>(D - VEC);")],
    "K5 backward: the row's last 16-byte chunk of dx not stored": [
        (ROWNORM, "if (c < nc && a.dx != nullptr) {",
         "if (c + 1 < nc && a.dx != nullptr) {")],
    "K5 backward: the column sums without the last strip": [
        (ROWNORM, "for (int s = threadIdx.y; s < a.strips; s += SUM_LANES)",
         "for (int s = threadIdx.y; s < a.strips - 1; s += SUM_LANES)")],
    "K6 the tensor's last whole vector not stored": [
        (WIDEN, "if (i < nvec) out[i] = widen_vec<SCALED>(v[u], s);",
         "if (i + 1 < nvec) out[i] = widen_vec<SCALED>(v[u], s);")],
    "K6 the scale not read": [
        (WIDEN, "const float s = SCALED ? __ldg(scale) : 1.0f;",
         "const float s = 1.0f;")],
    "K6 the scalar rest's last element skipped": [
        (WIDEN, "r < rest; r += total) {", "r + 1 < rest; r += total) {")],
}

_TIME_CHILD = r"""
import json, numpy as np, torch
from more4d_tpu_torch.geometry import (back_project_coords,
                                       generate_trajectory,
                                       get_intrinsic_matrix)
from more4d_tpu_torch.kernels.flash_attention import (
    _delta, flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
    scaled_q)
from more4d_tpu_torch.kernels.gs_splat import splat_cuda, tile_records

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
for name, lk in (("self", L), ("cross_text", 512), ("cross_clip", 257)):
    q2, k2, v2 = (torch.randn(2, n, h, d, device=dev, generator=g).bfloat16()
                  for n in (L, lk, lk))
    q, do = (torch.randn(1, L, h, d, device=dev, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(1, lk, h, d, device=dev, generator=g).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v)
    delta, qp = _delta(o, do), scaled_q(q, d ** -0.5)
    out[name] = dict(
        k1_ms=ms(lambda: flash_attention_cuda(q2, k2, v2)),
        k2_ms=ms(lambda: flash_bwd_dq_cuda(qp, k, v, None, do, lse, delta)),
        k3_ms=ms(lambda: flash_bwd_dkv_cuda(qp, k, v, None, do, lse, delta)))
    del q2, k2, v2, q, do, k, v, o, lse, delta, qp

H, W, F = 368, 512, 49
rs = np.random.RandomState(0)
depth = torch.from_numpy((1.0 + 5.0 * rs.rand(H, W)).astype(np.float32))
pts = back_project_coords(depth.to(dev), H, W).reshape(-1, 3)
cols = torch.from_numpy(rs.rand(pts.shape[0], 3).astype(np.float32)).to(dev)
ext = torch.from_numpy(generate_trajectory(
    "circle_rotating", pts.mean(0).cpu().numpy(), F)).to(dev)
*rec, (_, tx) = tile_records(pts.expand(F, -1, -1), cols, ext,
                             get_intrinsic_matrix(H, W, device=dev), H, W)
out["trajectory"] = dict(k4_ms=ms(lambda: splat_cuda(*rec, tx)))
print(json.dumps(out))
"""

_BUILD_CMD = [sys.executable, "-c", "from more4d_tpu_torch.kernels import "
              "_build; _build.build_all()"]
_TEST_CMD = [sys.executable, "-m", "pytest",
             "tests/test_torch_kernels_cuda.py", "-m", "cuda", "--noconftest",
             "-q", "-p", "no:cacheprovider"]


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
    """The package, the card tests and the built libraries in ``workdir``
    with ``edits`` made; the copy's libraries all built (one nvcc a
    source, together). Returns the environment that imports the copy."""
    shutil.copytree(ROOT / "more4d_tpu_torch", workdir / "more4d_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (workdir / "tests").mkdir()
    shutil.copy(ROOT / "tests/test_torch_kernels_cuda.py", workdir / "tests")
    if (ROOT / "build").is_dir():
        (workdir / "build").mkdir()
        for lib in (ROOT / "build").glob("lib*"):
            shutil.copy(lib, workdir / "build")
    apply_edits(workdir, edits)
    env = dict(os.environ, PYTHONPATH=str(workdir))
    subprocess.run(_BUILD_CMD, cwd=workdir, env=env, check=True,
                   capture_output=True, text=True, timeout=900)
    return env


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


def _times(r: dict) -> str:
    return "  ".join(f"{shape} " + " ".join(
        f"{k[:2].upper()} {t:.4f}" for k, t in ms.items())
        for shape, ms in r.items())


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
    if mode == "time":
        word = argv[1] if len(argv) > 1 else ""
        variants = {n: e for n, e in TIMINGS.items()
                    if not e or word in n}
    else:
        word = argv[1] if len(argv) > 1 else ""
        variants = {"as is": [],
                    **{n: e for n, e in FAULTS.items() if word in n}}
    for name, edits in variants.items():
        with tempfile.TemporaryDirectory() as tmp:
            if mode == "time":
                results[name] = r = time_variant(edits, Path(tmp))
                print(f"{name:55s} {_times(r)} ms", flush=True)
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
