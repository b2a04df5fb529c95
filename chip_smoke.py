#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``more4d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:

1. build the hand-written kernels from ``more4d_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (K1 the forward, K2/K3 the attention backward,
   K4 the splat), reject faults planted through the inputs, and time
   kernel, plain version and the PyTorch library call where one exists;
3. the inference path: ``run_two_stage`` at the 1.3B operating point (49
   frames at 368x512, random weights from a seed, fixed-seed encoder
   outputs, two sampler steps per stage, two trajectories inpainted), then
   the full 11-trajectory render sweep; every kernel must have launched,
   outputs must be finite and in range; one CFG-doubled DiT step is timed,
   the DiT with its kernels is held against the same DiT with the plain
   attention on a small input, and one DiT step and one stage 1 are
   profiled (device time by kernel kind, the device's idle share);
4. the training path: ``StraagTrainer.train`` on the 1.3B 4D-STraG DiT
   (fp32 params, bf16 compute, remat) for three AdamW steps at 49 frames
   of 368x512 from synthetic scene-flow samples; K1, K2 and K3 must have
   launched, losses must be finite, params and EMA must move; the DiT's
   gradients with its kernels are held against those with the plain
   attention, and one train step and its batch preparation are profiled;
5. print the kernels line, the card's name and power limit, and the
   device line last.

Exits non-zero without a result when CUDA is unavailable or the package is
not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

H, W, FRAMES, STEPS = 368, 512, 49, 2
PROMPT = "a cat walking on grass"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
SPLAT_FLOPS_PER_PAIR = 20          # per (record, pixel): distance, exp
                                   # argument, weight, colour, transmittance


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for cuBLAS and cuDNN inside the block, so that a plain
    version computes its fp32 in full fp32; the flags are restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bound_ms(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


# --------------------------------------------------------------------- K1

def bf16_ulp(x):
    """The spacing of bf16 numbers at magnitude ``x`` (8 significant
    bits)."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


def k1_errors(o, lse, o_ref, lse_ref):
    """(max |O - plain|, max |lse - plain|, tolerance on O, |O - plain| /
    |plain| in the 2-norm). Both sides round O to bf16, so one element may
    differ by one bf16 ulp of the largest |O| where the two fp32 values
    straddle a rounding boundary; the kernel also rounds P to bf16 against
    each 64-key tile's running max where the plain version uses the row's
    max, which moves O far less. Hence 2 ulps of the largest |O|. The
    relative 2-norm is held to REL_TOL, the lse (fp32 on both sides, only
    the order of its sums differs) to LSE_TOL."""
    diff = o.float() - o_ref.float()
    err = diff.abs().max().item()
    err_lse = (lse - lse_ref).abs().max().item()
    tol = 2 * bf16_ulp(o_ref.float().abs().max().item())
    rel = (diff.norm() / o_ref.float().norm()).item()
    return err, err_lse, tol, rel


LSE_TOL = 1e-4     # base-2 lse, magnitude ~20 here: ~50 fp32 ulps
REL_TOL = 5e-3     # twice the bf16 rounding floor (2.4e-3 on the self case)
K1_BLOCK_K = 64    # csrc/flash_attention.cu BK


def flash_phase(dev):
    """K1 against its plain version at the main path's attention shapes.
    Each case also plants the faults the comparison must catch, by giving
    the kernel the kv-lengths a faulty kernel would use: the last key tile
    dropped, and row 0's kv-length used for every row."""
    import torch
    import torch.nn.functional as F

    from more4d_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain)

    b, h, d, L = 2, 12, 128, 9568
    cases = [("self", L, L, [L, L]), ("self_short_kv", L, L, [L, 7000]),
             ("cross_text", L, 512, None), ("cross_clip", L, 257, None),
             ("ragged_17_9", 17, 9, [9, 5]), ("ragged_40_24", 40, 24,
                                               [24, 11])]
    gen = torch.Generator(dev).manual_seed(0)
    out, worst = {}, (0.0, 1.0)
    for name, lq, lk, lens in cases:
        q = torch.randn(b, lq, h, d, device=dev, generator=gen).bfloat16()
        k = torch.randn(b, lk, h, d, device=dev, generator=gen).bfloat16()
        v = torch.randn(b, lk, h, d, device=dev, generator=gen).bfloat16()
        kv = (None if lens is None else
              torch.tensor(lens, dtype=torch.int32, device=dev))

        def plain():
            # per batch row, so the [H, Lq, Lk] fp32 scores stay ~4 GB
            outs = [flash_attention_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1],
                None if kv is None else kv[i:i + 1]) for i in range(b)]
            return (torch.cat([o for o, _ in outs]),
                    torch.cat([s for _, s in outs]))

        o, lse = flash_attention_cuda(q, k, v, kv)
        with exact_fp32():
            o_ref, lse_ref = plain()
        torch.cuda.synchronize()
        err, err_lse, tol, rel = k1_errors(o, lse, o_ref, lse_ref)
        log(f"K1 {name:14s} q[{b},{lq},{h},{d}] k[{b},{lk},{h},{d}] "
            f"kv_lens={lens}: max|O-plain| {err:.3e} (tol {tol:.3e}, max|O| "
            f"{o_ref.float().abs().max().item():.3e}), |O-plain|/|plain| "
            f"{rel:.3e} (tol {REL_TOL}), max|lse-plain| {err_lse:.3e} "
            f"(tol {LSE_TOL})")
        if not (err <= tol and rel <= REL_TOL and err_lse <= LSE_TOL):
            raise AssertionError(f"K1 {name}: max |O - plain| {err:.3e} "
                                 f"(tolerance {tol:.3e}), |O - plain| / "
                                 f"|plain| {rel:.3e} (tolerance {REL_TOL}), "
                                 f"max |lse - plain| {err_lse:.3e} "
                                 f"(tolerance {LSE_TOL})")
        worst = max(worst, (err, tol), key=lambda et: et[0] / et[1])

        live = lens or [lk] * b
        faults = {"last key tile dropped": [n - (n % K1_BLOCK_K or K1_BLOCK_K)
                                        for n in live]}
        if len(set(live)) > 1:
            faults["row 0's kv_len for every row"] = [live[0]] * b
        caught = {}
        for fault, bad in faults.items():
            if min(bad) <= 0:
                continue
            fo, flse = flash_attention_cuda(
                q, k, v, torch.tensor(bad, dtype=torch.int32, device=dev))
            ferr, ferr_lse, _, frel = k1_errors(fo, flse, o_ref, lse_ref)
            if ferr <= tol and frel <= REL_TOL and ferr_lse <= LSE_TOL:
                raise AssertionError(f"K1 {name}: the comparison does not "
                                     f"catch the planted fault '{fault}'")
            caught[fault] = dict(max_abs_err=ferr, rel_err=frel,
                                 max_abs_err_lse=ferr_lse)
            log(f"K1 {name:14s} planted fault '{fault}' (kv_lens={bad}): "
                f"max|O-plain| {ferr:.3e}, |O-plain|/|plain| {frel:.3e}, "
                f"max|lse-plain| {ferr_lse:.3e}: rejected")

        big = lq * lk > 1e6
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, kv),
                     10 if big else 50)
        with exact_fp32():
            plain_ms = cuda_ms(plain, 2 if big else 10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if kv is not None:
            mask = (torch.arange(lk, device=dev)[None, :]
                    < kv[:, None])[:, None, None, :]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 10 if big else 50)
        keys = lk * b if lens is None else sum(lens)
        flops = 4.0 * h * lq * keys * d
        nbytes = 2 * (2 * b * lq * h * d + 2 * b * lk * h * d) \
            + 4 * b * h * lq + (0 if kv is None else 4 * b)
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        out[name] = dict(max_abs_err=err, tolerance=tol, rel_err=rel,
                         tolerance_rel=REL_TOL, max_abs_err_lse=err_lse,
                         tolerance_lse=LSE_TOL,
                         planted_faults=caught, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bms, bound_by=by,
                         flops=flops, bytes=nbytes)
        log(f"K1 {name:14s} kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v
        torch.cuda.empty_cache()
    return out, worst[0], worst[1]


# ------------------------------------------------------------------ K2, K3

BWD_ULPS = 2        # see bwd_errors
BWD_REL_TOL = 2e-3  # 7x the largest measured (2.9e-4), 17x under the
                    # smallest planted fault (3.4e-2)


def bwd_errors(got, want):
    """For each of dq, dk, dv: (max |kernel - plain|, its tolerance,
    |kernel - plain| / |plain| in the 2-norm). Both sides round every
    output to bf16 once, and P and dS to bf16 per term at the same points
    from the same fp32 recipe; only the order of the fp32 sums differs, so
    an element may sit one rounding flip away (measured: one ulp of the
    largest value at most), and a term's flip moves a sum by far less:
    BWD_ULPS bf16 ulps of the plain version's largest value. The relative
    2-norm is held to BWD_REL_TOL."""
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = g.float() - w.float()
        out[name] = (diff.abs().max().item(),
                     BWD_ULPS * bf16_ulp(w.float().abs().max().item()),
                     (diff.norm() / w.float().norm()).item())
    return out


def _bwd_ok(errs):
    return all(e <= tol and rel <= BWD_REL_TOL
               for e, tol, rel in errs.values())


def flash_bwd_phase(dev):
    """K2 (dq) and K3 (dk, dv) against their plain version at the training
    path's attention shapes (batch 1: self-attention over 9,568 tokens,
    text cross-attention over 512 keys, CLIP over 257), a batch-2
    self-attention with a short key set, and two ragged cases. Every case
    also plants the faults the comparison must catch, through the inputs:
    the last key tile dropped (the kv-lengths a faulty kernel would use),
    and an lse that is off by 0.05 (P off by 3.4%). Times K2, K3, the
    plain backward and SDPA's backward (its forward plus backward, less
    its forward)."""
    import torch
    import torch.nn.functional as F

    from more4d_tpu_torch.kernels.flash_attention import (
        _delta, flash_attention_bwd_plain, flash_attention_cuda,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)

    h, d, L = 12, 128, 9568
    cases = [("self", 1, L, L, [L]), ("self_short_kv", 2, L, L, [L, 7000]),
             ("cross_text", 1, L, 512, None), ("cross_clip", 1, L, 257, None),
             ("ragged_17_9", 2, 17, 9, [9, 5]),
             ("ragged_40_24", 2, 40, 24, [24, 11])]
    gen = torch.Generator(dev).manual_seed(3)
    out = {}
    for name, b, lq, lk, lens in cases:
        q, do = (torch.randn(b, lq, h, d, device=dev, generator=gen
                             ).bfloat16() for _ in range(2))
        k, v = (torch.randn(b, lk, h, d, device=dev, generator=gen
                            ).bfloat16() for _ in range(2))
        kv = (None if lens is None else
              torch.tensor(lens, dtype=torch.int32, device=dev))
        o, lse = flash_attention_cuda(q, k, v, kv)
        delta = _delta(o, do)

        def kernels(kv_=kv, lse_=lse):
            dq = flash_bwd_dq_cuda(q, k, v, kv_, do, lse_, delta)
            return (dq, *flash_bwd_dkv_cuda(q, k, v, kv_, do, lse_, delta))

        def plain():
            # per batch row, so the [H, Lq, Lk] fp32 intermediates stay
            # ~4.4 GB each
            rows = [flash_attention_bwd_plain(
                q[i:i + 1], k[i:i + 1], v[i:i + 1],
                None if kv is None else kv[i:i + 1], o[i:i + 1],
                lse[i * h:(i + 1) * h], do[i:i + 1]) for i in range(b)]
            return tuple(torch.cat(t) for t in zip(*rows))

        got = kernels()
        with exact_fp32():
            want = plain()
        torch.cuda.synchronize()
        errs = bwd_errors(got, want)
        for (g_name, (err, tol, rel)), w in zip(errs.items(), want):
            log(f"K2/K3 {name:14s} q[{b},{lq},{h},{d}] k[{b},{lk},{h},{d}] "
                f"kv_lens={lens}: {g_name} max|kernel-plain| {err:.3e} (tol "
                f"{tol:.3e}, max|plain| {w.float().abs().max().item():.3e}), "
                f"rel {rel:.3e} (tol {BWD_REL_TOL})")
        if not _bwd_ok(errs):
            raise AssertionError(f"K2/K3 {name}: {errs}")
        if lens is not None:
            for i, n in enumerate(lens):
                if got[1][i, n:].any() or got[2][i, n:].any():
                    raise AssertionError(f"K3 {name}: masked keys of row "
                                         f"{i} got nonzero dk or dv")

        live = lens or [lk] * b
        faults = {"lse off by 0.05": dict(lse_=lse + 0.05)}
        if min(n - (n % K1_BLOCK_K or K1_BLOCK_K) for n in live) > 0:
            faults["last key tile dropped"] = dict(kv_=torch.tensor(
                [n - (n % K1_BLOCK_K or K1_BLOCK_K) for n in live],
                dtype=torch.int32, device=dev))
        caught = {}
        for fault, kw in faults.items():
            ferrs = bwd_errors(kernels(**kw), want)
            if _bwd_ok(ferrs):
                raise AssertionError(f"K2/K3 {name}: the comparison does not "
                                     f"catch the planted fault '{fault}'")
            caught[fault] = {g: dict(max_abs_err=e, rel_err=r)
                             for g, (e, _, r) in ferrs.items()}
            log(f"K2/K3 {name:14s} planted fault '{fault}': " + ", ".join(
                f"{g} max {e:.3e} rel {r:.3e}"
                for g, (e, _, r) in ferrs.items()) + ": rejected")

        big = lq * lk > 1e6
        reps = 10 if big else 50
        ms_dq = cuda_ms(lambda: flash_bwd_dq_cuda(q, k, v, kv, do, lse,
                                                  delta), reps)
        ms_dkv = cuda_ms(lambda: flash_bwd_dkv_cuda(q, k, v, kv, do, lse,
                                                    delta), reps)
        with exact_fp32():
            plain_ms = cuda_ms(plain, 2 if big else 10)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        mask = None
        if kv is not None and min(lens) < lk:
            mask = (torch.arange(lk, device=dev)[None, :]
                    < kv[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        with torch.no_grad():
            sdpa_fwd_ms = cuda_ms(sdpa, reps)
        lib_ms = cuda_ms(sdpa_fwd_bwd, reps) - sdpa_fwd_ms

        keys = sum(live)
        unit = h * lq * keys * d
        io = 2 * (2 * b * lq * h * d + 2 * b * lk * h * d) + 8 * b * h * lq
        bms_dq, by_dq = bound_ms(io + 2 * b * lq * h * d, 6.0 * unit,
                                 BF16_FLOPS)
        bms_dkv, by_dkv = bound_ms(io + 4 * b * lk * h * d, 8.0 * unit,
                                   BF16_FLOPS)
        out[name] = dict(
            errors={g: dict(max_abs_err=e, tolerance=t, rel_err=r,
                            tolerance_rel=BWD_REL_TOL)
                    for g, (e, t, r) in errs.items()},
            planted_faults=caught, ms_dq=ms_dq, ms_dkv=ms_dkv,
            plain_ms=plain_ms, library_ms=lib_ms, sdpa_fwd_ms=sdpa_fwd_ms,
            bound_ms_dq=bms_dq, bound_by_dq=by_dq, bound_ms_dkv=bms_dkv,
            bound_by_dkv=by_dkv)
        log(f"K2/K3 {name:14s} K2 {ms_dq:.4f} ms (bound {bms_dq:.4f}, "
            f"{by_dq}, {6.0 * unit / ms_dq / 1e9:.1f} TFLOP/s), K3 "
            f"{ms_dkv:.4f} ms (bound {bms_dkv:.4f}, {by_dkv}, "
            f"{8.0 * unit / ms_dkv / 1e9:.1f} TFLOP/s), plain backward "
            f"{plain_ms:.3f} ms, SDPA backward {lib_ms:.4f} ms (its forward "
            f"{sdpa_fwd_ms:.4f} ms)")
        del q, k, v, do, o, lse, delta, got, want, qt, kt, vt
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- K4

def splat_phase(dev):
    """K4 against its plain version at the main path's launch: one
    trajectory of 49 frames over the 368x512 depth lift (188,416 points),
    as ``gs_render_sweep`` launches it; and one frame of the same cloud
    with a tile crowded past max_per_tile."""
    import torch

    from more4d_tpu_torch.geometry import (back_project_coords,
                                           generate_trajectory,
                                           get_intrinsic_matrix)
    from more4d_tpu_torch.kernels.gs_splat import (splat_cuda, splat_plain,
                                                   tile_records)

    tol = 1e-4
    rs = np.random.RandomState(0)
    depth = torch.from_numpy((1.0 + 5.0 * rs.rand(H, W)).astype(np.float32))
    pts = back_project_coords(depth.to(dev), H, W).reshape(-1, 3)
    cols = torch.from_numpy(rs.rand(pts.shape[0], 3).astype(np.float32)
                            ).to(dev)
    ext = torch.from_numpy(generate_trajectory(
        "circle_rotating", pts.mean(0).cpu().numpy(), FRAMES)).to(dev)
    intr = get_intrinsic_matrix(H, W, device=dev)
    mid = (H // 2) * W + W // 2                # a point at the centre
    crowd = pts[mid:mid + 1] + 1e-4 * torch.randn(1500, 3, device=dev)
    cases = {"trajectory": (pts.expand(FRAMES, -1, -1), cols, ext),
             "crowded_tile": (torch.cat([pts, crowd])[None],
                              torch.cat([cols, cols[:1500]]),
                              ext[FRAMES // 3:FRAMES // 3 + 1])}
    out, worst = {}, 0.0
    for name, (p, c, e) in cases.items():
        *rec, (_, tx) = tile_records(p, c, e, intr, H, W)
        counts = rec[5]
        img, alpha = splat_cuda(*rec, tx)
        with exact_fp32():
            img_ref, alpha_ref = splat_plain(*rec, tx)
        torch.cuda.synchronize()
        err = max((img - img_ref).abs().max().item(),
                  (alpha - alpha_ref).abs().max().item())
        if not err < tol:
            raise AssertionError(f"K4 {name}: max |out - plain| {err:.3e} "
                                 f"(tolerance {tol})")
        if name == "crowded_tile" and int(counts.max()) != rec[0].shape[-1]:
            raise AssertionError("K4 crowded_tile: no tile reached "
                                 "max_per_tile")
        worst = max(worst, err)
        ms = cuda_ms(lambda: splat_cuda(*rec, tx), 50)
        with exact_fp32():
            plain_ms = cuda_ms(lambda: splat_plain(*rec, tx), 3)
        live = int(counts.sum())
        pairs = live * 256
        # records (u, v, sigma, opacity, 3 colours) and counts read once,
        # image and alpha written once
        nbytes = live * (4 + 3) * 4 + counts.numel() * 4 \
            + p.shape[0] * H * W * 4 * 4
        bms, by = bound_ms(nbytes, pairs * SPLAT_FLOPS_PER_PAIR, FP32_FLOPS)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bms, bound_by=by,
                         pairs=pairs, max_count=int(counts.max()))
        log(f"K4 {name:13s} frames={p.shape[0]} N={p.shape[1]} "
            f"tiles={counts.shape[1]} records={live} "
            f"max/tile={int(counts.max())} pairs={pairs:.3e}: "
            f"max|out-plain| {err:.3e} (tol {tol}) | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
    return out, worst, tol


# --------------------------------------------------------------- main path

def main_path(dev):
    import torch

    from more4d_tpu_torch.config import PipelineConfig, dit_1_3b
    from more4d_tpu_torch.infer import (build_two_stage_models,
                                        render_trajectories, run_two_stage,
                                        stage1_generate)
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda

    t0 = time.perf_counter()
    pcfg = PipelineConfig(num_inference_steps=STEPS, num_frames=FRAMES,
                          height=H, width=W)
    m = build_two_stage_models(stand_in_encoders(dit_1_3b(), 0, dev), pcfg,
                               seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"main path: models built in {time.perf_counter() - t0:.1f} s "
        f"(1.3B 4D-STraG DiT + 1.3B InP DiT in bf16, Wan VAE in bf16)")
    rs = np.random.RandomState(0)
    image = rs.rand(H, W, 3).astype(np.float32)
    depth = (1.0 + 5.0 * rs.rand(H, W)).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    splat_cuda.launches = 0
    timings = {}
    t0 = time.perf_counter()
    out = run_two_stage(m, image, PROMPT, depth=depth,
                        trajectory_types=[("static", {}),
                                          ("circle_rotating", {})],
                        timings=timings)
    t1 = time.perf_counter()
    sweep = render_trajectories(out["coords"], out["colors"], H, W)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"flash_attention": flash_attention_cuda.launches,
                "gs_splat": splat_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    tokens = ((FRAMES - 1) // 4 + 1) * (H // 16) * (W // 16)
    log(f"main path: run_two_stage {t1 - t0:.2f} s (stage 1 "
        f"{timings['stage1_s']:.2f} s, render {timings['render_s']:.2f} s, "
        f"stage 2 {timings['stage2_s']:.2f} s for 2 trajectories), "
        f"11-trajectory sweep {t2 - t1:.2f} s, peak memory {peak:.2f} GiB, "
        f"{tokens} tokens, {STEPS} steps per stage")
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    coords, colors = out["coords"], out["colors"]
    assert coords.shape == (FRAMES, H * W, 3), coords.shape
    assert torch.isfinite(coords).all() and torch.isfinite(colors).all()
    assert len(out["videos"]) == 2 and len(sweep) == 11
    for v in out["videos"]:
        x = v["video"]
        assert x.shape == (FRAMES, H, W, 3), x.shape
        assert torch.isfinite(x).all(), v["name"]
        assert x.min() >= 0 and x.max() <= 1, v["name"]
    for r in sweep:
        assert r["frames"].shape == (FRAMES, H, W, 3)
        assert torch.isfinite(r["frames"]).all(), r["name"]
        assert r["mask"].dtype == torch.bool
    static_cover = 1.0 - sweep[0]["mask"][0].float().mean().item()
    if static_cover < 0.5:
        raise AssertionError(f"static camera covers {static_cover:.2f} of "
                             f"frame 0; expected most of it")
    log(f"main path outputs: finite, videos in [0, 1], static-camera "
        f"frame-0 coverage {static_cover:.3f}")

    step = dit_step(m, dev)
    step_ms = cuda_ms(step, 3)
    log(f"DiT step (CFG-doubled batch 2, 30 layers, 1.3B): {step_ms:.1f} ms")
    check_dit_against_plain(m, dev)
    stats = dict(timings, run_two_stage_s=t1 - t0, sweep_s=t2 - t1,
                 peak_gib=peak, dit_step_s=step_ms / 1e3)
    profile_phase({"dit_step": step,
                   "stage1": lambda: stage1_generate(m, image, PROMPT,
                                                     depth=depth)})
    return launches, stats


def stand_in_encoders(dit_cfg, seed, dev):
    """Stand-ins for the text, CLIP and OmniMAE towers, which the port does
    not have yet: each returns a fixed-seed tensor of the tower's real
    output shape (text [B, text_len, text_dim], CLIP [B, clip_tokens,
    clip_dim], MPM [B, 196, motion_feature_dim]) whatever its input."""
    import torch

    def fixed(i, shape, scale):
        g = torch.Generator().manual_seed(seed + i)
        return (torch.randn(shape, generator=g) * scale).to(dev)

    text = fixed(0, (1, dit_cfg.text_len, dit_cfg.text_dim), 0.1)
    clip = fixed(1, (1, dit_cfg.clip_tokens, dit_cfg.clip_dim), 1.0)
    mpm = fixed(2, (1, 196, dit_cfg.motion_feature_dim), 1.0)
    return (lambda prompts: text.expand(len(prompts), -1, -1),
            lambda images: clip.expand(images.shape[0], -1, -1),
            lambda images: mpm.expand(images.shape[0], -1, -1))


def dit_step(m, dev):
    """One CFG-doubled stage-1 DiT forward at the operating point (batch
    2, 9,568 tokens), as a closure."""
    import torch

    pipe = m.control_pipeline
    cfg = pipe.dit.cfg
    g = torch.Generator(dev).manual_seed(1)
    lat = (2, (FRAMES - 1) // 4 + 1, H // 8, W // 8)
    x = torch.randn(*lat, 16, device=dev, generator=g)
    y = torch.randn(*lat, cfg.in_dim - 16, device=dev, generator=g)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, device=dev, generator=g)
    clip = torch.randn(2, cfg.clip_tokens, cfg.clip_dim, device=dev,
                       generator=g)
    mpm = torch.randn(2, 196, cfg.motion_feature_dim, device=dev,
                      generator=g)
    t = torch.full((2,), 900.0, device=dev)

    def step():
        with torch.no_grad():
            return pipe.dit(x, t, ctx, y=y, clip_fea=clip, mpm_features=mpm,
                            rope_tables=pipe.rope_tables)

    return step


def _kernel_kind(name):
    """The kind of a device kernel, by its name: the port's kernels, the
    foreach kernels of AdamW and the EMA, cuDNN convolutions (with their
    layout transposes), cuBLAS matmuls, PyTorch's dtype casts and copies,
    reductions, other elementwise kernels."""
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "K1 flash_attention"
    if "flash_bwd_dq_kernel" in name:
        return "K2 flash_attention_bwd_dq"
    if "flash_bwd_dkv_kernel" in name:
        return "K3 flash_attention_bwd_dkv"
    if "multi_tensor_apply" in low:
        return "optimizer and EMA (foreach)"
    if "splat_kernel" in name:
        return "K4 gs_splat"
    if any(s in low for s in ("cudnn", "fprop", "dgrad", "conv", "winograd",
                              "nchwtonhwc", "nhwctonchw")):
        return "convolution (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    if any(s in low for s in ("copy", "memcpy", "memset")):
        return "dtype casts and copies"
    if "reduce" in low:
        return "reductions (norm statistics)"
    return "other elementwise"


def profile_phase(fns):
    """For each named closure, its wall time with the device synchronised, then the device time of every kernel over one more run
    under ``torch.profiler``, grouped by kind; the device's idle share is
    1 - (kernel time) / (unprofiled wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    report = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.events():
            # the optimizer's "Optimizer.step#AdamW.step" range is recorded
            # on the device too; it spans kernels already counted
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("Optimizer.")):
                ms, n = per_kernel.get(e.name, (0.0, 0))
                per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                                      n + 1)
        busy = sum(ms for ms, _ in per_kernel.values())
        kinds = {}
        for k, (ms, _) in per_kernel.items():
            kinds[_kernel_kind(k)] = kinds.get(_kernel_kind(k), 0.0) + ms
        log(f"profile {name}: wall {wall_ms:.1f} ms, kernels {busy:.1f} ms, "
            f"device idle {1 - busy / wall_ms:.3f} of the wall")
        for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
            log(f"  {kind:40s} {ms:10.2f} ms  {ms / wall_ms:6.3f} of wall")
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        for k, (ms, n) in top:
            log(f"    {ms:9.2f} ms {n:6d} x  {k[:110]}")
        report[name] = dict(wall_ms=wall_ms, kernel_ms=busy,
                            idle_share=1 - busy / wall_ms, by_kind=kinds)
    log("profile: " + json.dumps(report))


def small_dit_inputs(cfg, dev, seed):
    """A small DiT input from ``seed``: (latents [1, 2, 8, 8, 16], t = 500,
    text [1, 20, text_dim], y, CLIP and MPM features)."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(1, 2, 8, 8, 16, device=dev, generator=g)
    y = torch.randn(1, 2, 8, 8, cfg.in_dim - 16, device=dev, generator=g)
    ctx = torch.randn(1, 20, cfg.text_dim, device=dev, generator=g)
    clip = torch.randn(1, cfg.clip_tokens, cfg.clip_dim, device=dev,
                       generator=g)
    mpm = torch.randn(1, 196, cfg.motion_feature_dim, device=dev,
                      generator=g)
    return x, torch.full((1,), 500.0, device=dev), ctx, y, clip, mpm


def check_dit_against_plain(m, dev):
    """The stage-1 DiT with K1 against the same DiT with the plain
    attention, on a small input (5 frames at 64x64): relative error of the
    bf16 velocity below 5e-2."""
    import importlib

    import torch

    from more4d_tpu_torch.kernels import flash_attention as fa

    # the module itself: the package re-exports a function of the same name
    attn_mod = importlib.import_module("more4d_tpu_torch.nn.attention")
    pipe = m.control_pipeline
    x, t, ctx, y, clip, mpm = small_dit_inputs(pipe.dit.cfg, dev, 2)

    def run():
        # the block stack's output tokens: the random model's output head
        # is zero-initialised, so its velocity would be zero either way
        with torch.no_grad():
            dit = pipe.dit
            it = dit.embed(x, t, ctx, y=y, clip_fea=clip, mpm_features=mpm)
            return dit.backbone(it).float()

    before = fa.flash_attention_cuda.launches
    got = run()
    kernel_calls = fa.flash_attention_cuda.launches - before

    def plain_attention(q, k, v, kv_lens=None):
        if k.shape[1] == 0:
            return torch.zeros_like(q)
        return fa.flash_attention_plain(q, k, v, kv_lens)[0]

    real = attn_mod.flash_attention
    attn_mod.flash_attention = plain_attention
    try:
        before = fa.flash_attention_cuda.launches
        with exact_fp32():
            want = run()
        stray = fa.flash_attention_cuda.launches - before
    finally:
        attn_mod.flash_attention = real
    rel = ((got - want).norm() / want.norm().clamp_min(1e-12)).item()
    log(f"DiT blocks with K1 ({kernel_calls} launches) vs with the plain "
        f"attention ({stray} launches), 1x2x8x8 latents: relative error "
        f"{rel:.3e} (tol 5e-2)")
    if kernel_calls == 0 or stray != 0:
        raise AssertionError("the DiT comparison did not switch between K1 "
                             "and the plain attention")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"DiT with K1 disagrees with the plain "
                             f"attention: relative error {rel:.3e}")


# ------------------------------------------------------------ training path

TRAIN_STEPS = 3


def synthetic_sample(seed, frames=FRAMES, h=H, w=W):
    """A scene-flow sample made from a numpy seed, through the port's data
    preparation: the pixels of a random depth map (1-6 m) lifted through a
    pinhole camera, drifting by a per-pixel velocity over the frames."""
    from more4d_tpu_torch.data import prepare_straag_sample

    rs = np.random.RandomState(seed)
    depth = 1.0 + 5.0 * rs.rand(h, w)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    focal = 0.5 * w
    pts = np.stack([(xs - w / 2) / focal * depth,
                    (ys - h / 2) / focal * depth, depth], -1)
    vel = 0.01 * rs.randn(1, 1, 1, 3) + 0.002 * rs.randn(1, h, w, 3)
    coords = pts[None] + np.arange(frames)[:, None, None, None] * vel
    colors = 255.0 * rs.rand(h, w, 3)
    return prepare_straag_sample(coords.astype(np.float32),
                                 colors.astype(np.float32),
                                 max_num_frames=frames)


def build_trainer(dev, dit_cfg, output_dir, max_steps, seed=0):
    """The 4D-STraG trainer as the training CLI wires it, with random
    weights from ``seed``: the DiT with fp32 params and bf16 compute, the
    frozen Wan VAE in bf16 and the encoder adaptor, fixed-seed encoder
    stand-ins, AdamW at the shipped launch defaults (betas (0.9, 0.999),
    weight decay 3e-2, eps 1e-10, constant_with_warmup over 100 steps at
    lr 2e-5) and the EMA. The DiT's zero-initialised output head and FiLM
    projections and gates are drawn N(0, 0.02), as a fine-tune's
    checkpoint has them trained: at zero the blocks would get no
    gradient."""
    import torch

    from more4d_tpu_torch.config import VAEConfig
    from more4d_tpu_torch.models import VAEEncoderAdaptor, WanDiT, WanVAE
    from more4d_tpu_torch.train import (StraagRunConfig, StraagTrainConfig,
                                        StraagTrainer, make_adamw,
                                        make_lr_schedule)

    gen = torch.Generator(dev).manual_seed(seed)
    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    with torch.device(dev):
        dit = WanDiT(dit_cfg).init_weights(gen)
        with torch.no_grad():
            for name, p in dit.named_parameters():
                if (name.startswith("head.head") or name.endswith(".gate")
                        or ".spatial_guide." in name):
                    p.normal_(0.0, 0.02, generator=gen)
        vae = WanVAE(VAEConfig(**bf16)).init_weights(gen).to(torch.bfloat16)
        enc = VAEEncoderAdaptor()
    opt, sched = make_adamw(dit.parameters(), make_lr_schedule(
        2e-5, "constant_with_warmup", 100, max_steps))
    text, clip, mpm = stand_in_encoders(dit_cfg, seed, dev)
    return StraagTrainer(
        dit, vae, enc, text, StraagTrainConfig(learning_rate=2e-5),
        StraagRunConfig(output_dir=output_dir, max_steps=max_steps,
                        checkpointing_steps=max_steps + 1, log_steps=1,
                        seed=seed),
        encode_clip=clip, extract_mpm=mpm, optimizer=opt,
        lr_scheduler=sched)


def train_phase(dev):
    """The training path: ``StraagTrainer.train`` on the 1.3B 4D-STraG DiT
    (remat on) for TRAIN_STEPS steps at 49 frames of 368x512, batch 1,
    checkpointing set past the last step (a full checkpoint is ~27 GB).
    K1, K2 and K3 must all launch; every loss must be finite; params and
    EMA must move. Then the DiT's gradients with the kernels are held
    against those with the plain attention, and one train step and one
    prepare_batch are profiled."""
    import gc
    import json as _json
    import os

    import torch

    from more4d_tpu_torch.config import dit_1_3b
    from more4d_tpu_torch.kernels import _build
    from more4d_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from more4d_tpu_torch.train import draw, train_step

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = str(_build.BUILD / "chip_smoke_train")
    if os.path.exists(os.path.join(out_dir, "metrics.jsonl")):
        os.remove(os.path.join(out_dir, "metrics.jsonl"))
    t0 = time.perf_counter()
    cfg = dit_1_3b(motion_guidance=True, in_dim=64, model_type="i2v",
                   remat=True)
    trainer = build_trainer(dev, cfg, out_dir, TRAIN_STEPS)
    dit = trainer.dit
    n_params = sum(p.numel() for p in dit.parameters())
    samples = [synthetic_sample(i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    log(f"train: built in {time.perf_counter() - t0:.1f} s: 1.3B 4D-STraG "
        f"DiT ({n_params / 1e9:.3f}e9 params, fp32 params, bf16 compute, "
        f"remat 'nothing' on {len(dit.remat_blocks())} of "
        f"{cfg.num_layers} blocks), Wan VAE bf16, encoder adaptor fp32, "
        f"AdamW + EMA; {TRAIN_STEPS} synthetic samples of {FRAMES}x{H}x{W}")
    watch = ("patch_embedding.weight", "blocks.0.self_attn.q.weight",
             f"blocks.{cfg.num_layers - 1}.ffn.2.weight", "head.head.weight")
    params = dict(dit.named_parameters())
    before = {n: params[n].detach().clone() for n in watch}
    ema_before = {n: trainer.ema[n].clone() for n in watch}

    counters = (flash_attention_cuda, flash_bwd_dq_cuda, flash_bwd_dkv_cuda)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    timings = []
    trainer.train((([s], [PROMPT]) for s in samples), timings=timings)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention_cuda.launches,
                "flash_attention_bwd_dq": flash_bwd_dq_cuda.launches,
                "flash_attention_bwd_dkv": flash_bwd_dkv_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train launches over {TRAIN_STEPS} steps: {launches}; per step "
        + str({k: v / TRAIN_STEPS for k, v in launches.items()})
        + " (expected 180 K1: the forward and each block's recompute, "
          "90 K2, 90 K3)")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [_json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    moved = {n: (params[n] - before[n]).abs().max().item() for n in watch}
    ema_moved = {n: (trainer.ema[n] - ema_before[n]).abs().max().item()
                 for n in watch}
    log(f"train: losses {losses}, grad norms "
        f"{[r['train/grad_norm'] for r in records]}, skipped "
        f"{[r['train/skipped'] for r in records]}; max |param change| "
        f"{moved}; max |EMA change| {ema_moved}")
    if not (all(v > 0 for v in moved.values())
            and all(v > 0 for v in ema_moved.values())):
        raise AssertionError("params or EMA did not move")
    warm = timings[1:]
    prep_s = sum(t["prepare_s"] for t in warm) / len(warm)
    step_s = sum(t["step_s"] for t in warm) / len(warm)
    log(f"train: warm step {prep_s + step_s:.3f} s = prepare_batch "
        f"{prep_s:.3f} s + step {step_s:.3f} s (first step "
        f"{timings[0]['prepare_s']:.3f} + {timings[0]['step_s']:.3f} s); "
        f"peak memory {peak:.2f} GiB")

    check_dit_grads_against_plain(dit, dev)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    batch = trainer.prepare_batch([samples[0]], [PROMPT])
    torch.cuda.synchronize()
    peak_prepare = torch.cuda.max_memory_allocated() / 2 ** 30

    def one_step():
        idx, noise = draw(trainer.tcfg, batch, trainer.generator)
        train_step(dit, trainer.optimizer, trainer.ema, trainer.tcfg, batch,
                   idx, noise, TRAIN_STEPS, trainer.lr_scheduler)

    torch.cuda.reset_peak_memory_stats()
    one_step()
    torch.cuda.synchronize()
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train memory: {resident:.2f} GiB resident between steps (params, "
        f"AdamW m and v, EMA), peak {peak_prepare:.2f} GiB in "
        f"prepare_batch, {peak_step:.2f} GiB in the step")

    profile_phase({"train_step": one_step,
                   "prepare_batch": lambda: trainer.prepare_batch(
                       [samples[0]], [PROMPT])})
    stats = dict(train_step_s=prep_s + step_s, train_prepare_s=prep_s,
                 train_dit_step_s=step_s, train_peak_gib=peak,
                 train_resident_gib=resident,
                 train_peak_prepare_gib=peak_prepare,
                 train_peak_step_gib=peak_step,
                 train_loss_last=losses[-1])
    return launches, stats


def check_dit_grads_against_plain(dit, dev):
    """The training DiT's parameter gradients with K1, K2 and K3 against
    those with the plain attention forward and backward, on a small input
    (2 latent frames of 8x8): relative error of the whole gradient (the
    2-norm over every parameter) below 5e-2, as the forward check holds the
    block outputs."""
    import importlib

    import torch

    from more4d_tpu_torch.kernels import flash_attention as fa

    attn_mod = importlib.import_module("more4d_tpu_torch.nn.attention")
    x, t, ctx, y, clip, mpm = small_dit_inputs(dit.cfg, dev, 4)
    params = [p for p in dit.parameters() if p.requires_grad]

    def grads():
        pred = dit(x, t, ctx, y=y, clip_fea=clip, mpm_features=mpm)
        return torch.autograd.grad(pred.float().square().mean(), params)

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx_, q, k, v, kv_lens):
            o, lse = fa.flash_attention_plain(q, k, v, kv_lens)
            ctx_.save_for_backward(q, k, v, o, lse, kv_lens)
            return o

        @staticmethod
        def backward(ctx_, do):
            q, k, v, o, lse, kv_lens = ctx_.saved_tensors
            return (*fa.flash_attention_bwd_plain(q, k, v, kv_lens, o, lse,
                                                  do.contiguous()), None)

    def plain_attention(q, k, v, kv_lens=None):
        if k.shape[1] == 0:
            return torch.zeros_like(q)
        return PlainFlash.apply(q, k, v, kv_lens)

    counters = (fa.flash_attention_cuda, fa.flash_bwd_dq_cuda,
                fa.flash_bwd_dkv_cuda)
    before = [c.launches for c in counters]
    got = grads()
    kernel_calls = [c.launches - n for c, n in zip(counters, before)]
    real = attn_mod.flash_attention
    attn_mod.flash_attention = plain_attention
    try:
        before = [c.launches for c in counters]
        with exact_fp32():
            want = grads()
        stray = [c.launches - n for c, n in zip(counters, before)]
    finally:
        attn_mod.flash_attention = real
    num = sum((a.float() - b.float()).square().sum() for a, b in zip(got, want))
    den = sum(b.float().square().sum() for b in want)
    rel = (num.sqrt() / den.sqrt().clamp_min(1e-30)).item()
    names = [n for n, p in dit.named_parameters() if p.requires_grad]
    worst, worst_name = max(
        (((a.float() - b.float()).norm()
          / b.float().norm().clamp_min(1e-30)).item(), n)
        for a, b, n in zip(got, want, names))
    log(f"DiT gradients with K1/K2/K3 ({kernel_calls} launches) vs with the "
        f"plain attention forward and backward ({stray} launches), 1x2x8x8 "
        f"latents: relative error {rel:.3e} over all {len(params)} tensors "
        f"(tol 5e-2; the worst single tensor {worst_name}: {worst:.3e}, "
        f"|grad| {want[names.index(worst_name)].float().norm().item():.3e} "
        f"against {den.sqrt().item():.3e} over all)")
    if min(kernel_calls) == 0 or any(stray):
        raise AssertionError("the gradient comparison did not switch "
                             "between the kernels and the plain attention")
    if not (all(torch.isfinite(a).all() for a in got) and rel < 5e-2):
        raise AssertionError(f"DiT gradients with the kernels disagree with "
                             f"the plain attention: relative error {rel:.3e}")


# ------------------------------------------------------------------ driver

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        from more4d_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the more4d_tpu_torch package is not beside this "
              f"script ({e}); run it from the root of a checkout",
              file=sys.stderr)
        return 3

    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; the main path runs at PyTorch's "
        f"defaults (tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"tf32 cudnn {torch.backends.cudnn.allow_tf32}); every comparison "
        f"with a plain version runs with both off")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in secs:
        log_path = _build.BUILD / f"{name}.nvcc.log"
        if log_path.exists():
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    k1, k1_err, k1_tol = flash_phase(dev)
    bwd = flash_bwd_phase(dev)
    k4, k4_err, k4_tol = splat_phase(dev)
    launches, stats = main_path(dev)
    train_launches, train_stats = train_phase(dev)
    stats.update(train_stats)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    sa, fr, sb = k1["self"], k4["trajectory"], bwd["self"]

    def bwd_entry(kind, grads, line):
        errs = {c: max(v["errors"][g]["max_abs_err"] for g in grads)
                for c, v in bwd.items()}
        return dict(
            name=f"flash_attention_bwd_{kind}", route="cuda",
            source="more4d_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"more4d_tpu/kernels/flash_attention.py:{line}",
            launches=train_launches[f"flash_attention_bwd_{kind}"],
            max_abs_err=max(errs.values()), ms=sb[f"ms_{kind}"],
            plain_ms=sb["plain_ms"], bound_ms=sb[f"bound_ms_{kind}"],
            bound_by=sb[f"bound_by_{kind}"], library_ms=sb["library_ms"],
            library="SDPA backward (fwd+bwd less fwd; dq, dk and dv "
                    "together)",
            shape="training self-attention q/k/v/dO [1,9568,12,128] bf16",
            cases={c: dict(ms=v[f"ms_{kind}"], bound_ms=v[f"bound_ms_{kind}"],
                           plain_ms=v["plain_ms"],
                           library_ms=v["library_ms"],
                           errors={g: v["errors"][g] for g in grads})
                   for c, v in bwd.items()})

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="more4d_tpu_torch/csrc/flash_attention.cu",
             replaces="more4d_tpu/kernels/flash_attention.py:48",
             launches=launches["flash_attention"],
             launches_by_path={"run_two_stage": launches["flash_attention"],
                               "train": train_launches["flash_attention"]},
             max_abs_err=k1_err,
             tolerance=k1_tol, ms=sa["ms"], plain_ms=sa["plain_ms"],
             bound_ms=sa["bound_ms"], bound_by=sa["bound_by"],
             library_ms=sa["library_ms"],
             shape="self-attention q/k/v [2,9568,12,128] bf16",
             cases={k: {kk: vv for kk, vv in v.items()
                        if kk not in ("flops", "bytes")}
                    for k, v in k1.items()}),
        bwd_entry("dq", ("dq",), 216),
        bwd_entry("dkv", ("dk", "dv"), 250),
        dict(name="gs_splat", route="cuda",
             source="more4d_tpu_torch/csrc/gs_splat.cu",
             replaces="more4d_tpu/kernels/gs_splat.py:121",
             launches=launches["gs_splat"], max_abs_err=k4_err,
             tolerance=k4_tol, ms=fr["ms"], plain_ms=fr["plain_ms"],
             bound_ms=fr["bound_ms"], bound_by=fr["bound_by"],
             library_ms=None,
             shape="one trajectory: 49 frames of 368x512, 188,416 points, "
                   "736 tiles x 512 records",
             cases={k: {kk: vv for kk, vv in v.items()
                        if kk in ("ms", "plain_ms", "bound_ms",
                                  "max_abs_err")}
                    for k, v in k4.items()}),
    ]
    log("main path stats: " + json.dumps(
        {k: round(v, 4) for k, v in stats.items()}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
