#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``more4d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:

1. build the hand-written kernels from ``more4d_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and time kernel, plain version and the
   PyTorch library call where one exists;
3. the main path: ``run_two_stage`` at the 1.3B operating point (49 frames
   at 368x512, random weights from a seed, fixed-seed encoder outputs, two
   sampler steps per stage, two trajectories inpainted), then the full
   11-trajectory render sweep; every kernel must have launched, outputs
   must be finite and in range; one CFG-doubled DiT step is timed, the
   DiT with its kernels is held against the same DiT with the plain
   attention on a small input, and one DiT step and one stage 1 are
   profiled (device time by kernel kind, the device's idle share);
4. print the kernels line, the card's name and power limit, and the
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
    """The kind of a device kernel, by its name: the port's kernels, cuDNN
    convolutions (with their layout transposes), cuBLAS matmuls, PyTorch's
    dtype casts and copies, reductions, other elementwise kernels."""
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "K1 flash_attention"
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
            if e.device_type == torch.autograd.DeviceType.CUDA:
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
    cfg = pipe.dit.cfg
    g = torch.Generator(dev).manual_seed(2)
    x = torch.randn(1, 2, 8, 8, 16, device=dev, generator=g)
    y = torch.randn(1, 2, 8, 8, cfg.in_dim - 16, device=dev, generator=g)
    ctx = torch.randn(1, 20, cfg.text_dim, device=dev, generator=g)
    clip = torch.randn(1, cfg.clip_tokens, cfg.clip_dim, device=dev,
                       generator=g)
    mpm = torch.randn(1, 196, cfg.motion_feature_dim, device=dev,
                      generator=g)
    t = torch.full((1,), 500.0, device=dev)

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
    k4, k4_err, k4_tol = splat_phase(dev)
    launches, stats = main_path(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    sa, fr = k1["self"], k4["trajectory"]
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="more4d_tpu_torch/csrc/flash_attention.cu",
             replaces="more4d_tpu/kernels/flash_attention.py:48",
             launches=launches["flash_attention"], max_abs_err=k1_err,
             tolerance=k1_tol, ms=sa["ms"], plain_ms=sa["plain_ms"],
             bound_ms=sa["bound_ms"], bound_by=sa["bound_by"],
             library_ms=sa["library_ms"],
             shape="self-attention q/k/v [2,9568,12,128] bf16",
             cases={k: {kk: vv for kk, vv in v.items()
                        if kk not in ("flops", "bytes")}
                    for k, v in k1.items()}),
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
