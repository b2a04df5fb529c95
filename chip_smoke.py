#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``more4d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure:

1. build the hand-written kernels from ``more4d_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (K1 the forward at the inference and training
   batches, K2/K3 the attention backward, K4 the splat), reject faults
   planted through the inputs, and time kernel, plain version and the
   PyTorch library call where one exists (and K4's host prep,
   ``tile_records``);
3. the towers: umT5-xxl, CLIP ViT-H/14, OmniMAE ViT-B and UniDepth-V2
   ViT-L/14 at full width, random weights from a seed, stored in bf16 on
   the card; each timed on its main-path input, its peak memory logged,
   and held to its weights in fp32 with TF32 off;
4. the inference path as the JAX CLI runs it by default: ``run_two_stage``
   at the 1.3B operating point (49 frames at 368x512, random weights from
   a seed, the towers' conditioning with a stand-in tokenizer, the depth
   from UniDepth, TeaCache on at 0.10; two sampler steps per stage, two
   trajectories inpainted), then the full 11-trajectory render sweep;
   every kernel must have launched, outputs must be finite and in range;
   one CFG-doubled DiT step is timed, the DiT with its kernels is held
   against the same DiT with the plain attention on a small input, and one
   DiT step and one stage 1 are profiled (device time by kernel kind, the
   device's idle share);
5. TeaCache: the stage-1 denoise for 12 steps (2 warm); every step timed,
   a replay step must launch no K1 and a calc step 90;
6. the CLI (``more4d_tpu_torch.scripts.infer``) on synthetic released-
   layout checkpoints of the 1.3B width written by the port's writer
   (``cli_phase``): its ``load_models`` (sharded bf16 safetensors with the
   48->64 surgery, the kohya ViSM LoRA merged at 0.55, the towers and
   UniDepth from torch files) and ``run_sample`` with DPM++ for 3 steps a
   stage and 2 trajectories, then stage 1 again with UniPC; outputs, the
   merge, the fresh FiLM and K1/K4's launch counts are checked;
7. the training path: ``StraagTrainer.train`` on the 1.3B 4D-STraG DiT
   (fp32 params, bf16 compute, remat) for three AdamW steps at 49 frames
   of 368x512 from synthetic scene-flow samples; K1, K2 and K3 must have
   launched, losses must be finite, params and EMA must move; the DiT's
   gradients with its kernels are held against those with the plain
   attention, and one train step and its batch preparation are profiled
   (its text, CLIP and OmniMAE conditioning are still fixed-seed
   stand-ins);
8. print the kernels line, the card's name and power limit, and the
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


# The port's device kernels, each by a substring of its mangled name, and
# the kind the profile counts it under (K3's second pass, which sums the
# q-split's partials, is K3's work).
PORT_KERNELS = (("flash_fwd_kernel", "K1 flash_attention"),
                ("flash_bwd_dq_kernel", "K2 flash_attention_bwd_dq"),
                ("flash_bwd_dkv_kernel", "K3 flash_attention_bwd_dkv"),
                ("dkv_reduce_kernel", "K3 flash_attention_bwd_dkv"),
                ("splat_kernel", "K4 gs_splat"))


def ptxas_summary(text):
    """{kernel: "registers, spills, notes"} for each entry function in an
    ``nvcc -Xptxas -v`` log: the kernel named by its PORT_KERNELS
    substring, with ``<D>`` where it is a template on the head dim; its
    spills and any ptxas warning that follows it (such as serialised
    wgmma) kept."""
    import re

    out, kernel, info = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            if kernel:
                out[kernel] = "; ".join(info)
            mangled = m.group(1)
            kernel = next((sub for sub, _ in PORT_KERNELS if sub in mangled),
                          mangled)
            d = re.search(r"ILi(\d+)E", mangled)
            kernel += f"<{d.group(1)}>" if d else ""
            info = []
        elif kernel and ("registers" in line or "spill" in line
                         or "warning" in line.lower()):
            info.append(line.split(":", 1)[-1].strip())
    if kernel:
        out[kernel] = "; ".join(info)
    return out


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
    each key tile's running max where the plain version uses the row's
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


def without_last_key_tile(lens, block_k):
    """The kv-lengths a kernel that dropped its last key tile of
    ``block_k`` keys would use."""
    return [n - (n % block_k or block_k) for n in lens]


def flash_phase(dev):
    """K1 against its plain version at the main path's attention shapes
    (the CFG-doubled batch 2 of inference, batch 1 of training). Each case
    also plants the faults the comparison must catch, by giving the kernel
    the kv-lengths a faulty kernel would use: its last key tile (of the
    size its library reports) dropped, and row 0's kv-length used for
    every row."""
    import torch
    import torch.nn.functional as F

    from more4d_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, flash_fwd_tiles)

    h, d, L = 12, 128, 9568
    block_q, block_k = flash_fwd_tiles()
    log(f"K1 tiles: {block_q} q rows a CTA, {block_k} keys a tile")
    cases = [("self", 2, L, L, [L, L]), ("self_b1", 1, L, L, [L]),
             ("self_short_kv", 2, L, L, [L, 7000]),
             ("cross_text", 2, L, 512, None), ("cross_clip", 2, L, 257, None),
             ("ragged_17_9", 2, 17, 9, [9, 5]),
             ("ragged_40_24", 2, 40, 24, [24, 11])]
    gen = torch.Generator(dev).manual_seed(0)
    out, worst = {}, (0.0, 1.0)
    for name, b, lq, lk, lens in cases:
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
        faults = {"last key tile dropped": without_last_key_tile(live,
                                                                 block_k)}
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


DETERMINISM_CASES = ("self", "cross_text")


def flash_bwd_phase(dev):
    """K2 (dq) and K3 (dk, dv) against their plain version at the training
    path's attention shapes (batch 1: self-attention over 9,568 tokens,
    text cross-attention over 512 keys, CLIP over 257), a batch-2
    self-attention with a short key set, and two ragged cases. Every case
    also plants the faults the comparison must catch, through the inputs:
    the last key tile dropped (the kv-lengths a faulty kernel would use),
    and an lse that is off by 0.05 (P off by 3.4%). At DETERMINISM_CASES a
    second call must give the same bits. Times K2, K3 (and K3 without its
    q-split where it splits), the plain backward and SDPA's backward (its
    forward plus backward, less its forward)."""
    import torch
    import torch.nn.functional as F

    from more4d_tpu_torch.kernels.flash_attention import (
        _delta, _sm_count, dkv_splits, flash_attention_bwd_plain,
        flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_fwd_tiles, scaled_q)

    h, d, L = 12, 128, 9568
    block_k = flash_fwd_tiles()[1]
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
        qp = scaled_q(q, d ** -0.5)
        splits = dkv_splits(b, h, lq, lk, _sm_count(dev))

        def kernels(kv_=kv, lse_=lse):
            dq = flash_bwd_dq_cuda(qp, k, v, kv_, do, lse_, delta)
            return (dq, *flash_bwd_dkv_cuda(qp, k, v, kv_, do, lse_, delta))

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
        if name in DETERMINISM_CASES:
            again = kernels()
            same = [torch.equal(a, g) for a, g in zip(again, got)]
            log(f"K2/K3 {name:14s} determinism: a second call gives the same "
                f"bits for (dq, dk, dv): {same} (K3 splits {splits})")
            if not all(same):
                raise AssertionError(f"K2/K3 {name}: a second call gave "
                                     f"other bits: {same}")
            del again

        live = lens or [lk] * b
        faults = {"lse off by 0.05": dict(lse_=lse + 0.05)}
        short = without_last_key_tile(live, block_k)
        if min(short) > 0:
            faults["last key tile dropped"] = dict(kv_=torch.tensor(
                short, dtype=torch.int32, device=dev))
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
        ms_dq = cuda_ms(lambda: flash_bwd_dq_cuda(qp, k, v, kv, do, lse,
                                                  delta), reps)
        ms_dkv = cuda_ms(lambda: flash_bwd_dkv_cuda(qp, k, v, kv, do, lse,
                                                    delta), reps)
        ms_dkv_unsplit = None
        if splits > 1:
            ms_dkv_unsplit = cuda_ms(lambda: flash_bwd_dkv_cuda(
                qp, k, v, kv, do, lse, delta, splits=1), reps)
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
            splits=splits, ms_dkv_unsplit=ms_dkv_unsplit,
            tflops_dq=6.0 * unit / ms_dq / 1e9,
            tflops_dkv=8.0 * unit / ms_dkv / 1e9, plain_ms=plain_ms,
            library_ms=lib_ms, sdpa_fwd_ms=sdpa_fwd_ms,
            bound_ms_dq=bms_dq, bound_by_dq=by_dq, bound_ms_dkv=bms_dkv,
            bound_by_dkv=by_dkv)
        unsplit = ("" if ms_dkv_unsplit is None else
                   f"; {ms_dkv_unsplit:.4f} ms unsplit")
        log(f"K2/K3 {name:14s} K2 {ms_dq:.4f} ms (bound {bms_dq:.4f}, "
            f"{by_dq}, {out[name]['tflops_dq']:.1f} TFLOP/s), K3 "
            f"{ms_dkv:.4f} ms with {splits} splits (bound {bms_dkv:.4f}, "
            f"{by_dkv}, {out[name]['tflops_dkv']:.1f} TFLOP/s{unsplit}), "
            f"plain backward {plain_ms:.3f} ms, SDPA backward {lib_ms:.4f} "
            f"ms (its forward {sdpa_fwd_ms:.4f} ms)")
        del q, qp, k, v, do, o, lse, delta, got, want, qt, kt, vt
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
        # the host prep the render runs before each launch (projection,
        # tile assignment, the depth sort, the record gather)
        rec_ms = cuda_ms(lambda: tile_records(p, c, e, intr, H, W), 5)
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
                         tile_records_ms=rec_ms, pairs=pairs,
                         max_count=int(counts.max()))
        log(f"K4 {name:13s} frames={p.shape[0]} N={p.shape[1]} "
            f"tiles={counts.shape[1]} records={live} "
            f"max/tile={int(counts.max())} pairs={pairs:.3e}: "
            f"max|out-plain| {err:.3e} (tol {tol}) | kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
            f"{pairs / ms * 1e3:.3e} pairs/s; tile_records {rec_ms:.3f} ms")
    return out, worst, tol


# --------------------------------------------------------------- main path

def main_path(dev, towers):
    """``run_two_stage`` as the JAX CLI runs it by default: the four towers
    (``towers_phase``'s, bf16), the depth estimated by UniDepth, TeaCache on
    at the CLI's defaults (0.10, 5 warm steps, the 1.3B coefficients; the
    smoke run's 2 steps a stage are all warm)."""
    import torch

    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.infer import (build_encoders,
                                        build_two_stage_models,
                                        render_trajectories, run_two_stage,
                                        stage1_generate)
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda
    from more4d_tpu_torch.models import UniDepthProvider
    from more4d_tpu_torch.pipelines import (TEACACHE_COEFFICIENTS,
                                            TeaCacheConfig)

    t0 = time.perf_counter()
    pcfg = PipelineConfig(num_inference_steps=STEPS, num_frames=FRAMES,
                          height=H, width=W)
    encoders = build_encoders(t5=towers["t5"], tokenize=stand_in_tokenize,
                              clip=towers["clip"], omnimae=towers["omnimae"],
                              device=dev)
    teacache = TeaCacheConfig(tuple(TEACACHE_COEFFICIENTS["wan2.1-fun-1.3b"]),
                              rel_l1_thresh=0.10, num_skip_start_steps=5)
    m = build_two_stage_models(
        encoders, pcfg, seed=0, device=dev, teacache=teacache,
        estimate_depth=UniDepthProvider(model=towers["unidepth"],
                                        device=dev))
    torch.cuda.synchronize()
    log(f"main path: models built in {time.perf_counter() - t0:.1f} s "
        f"(1.3B 4D-STraG DiT + 1.3B InP DiT in bf16, Wan VAE in bf16; "
        f"umT5-xxl, CLIP ViT-H/14, OmniMAE ViT-B and UniDepth-V2 ViT-L/14 "
        f"stored in bf16; TeaCache 0.10 with 5 warm steps)")
    rs = np.random.RandomState(0)
    image = rs.rand(H, W, 3).astype(np.float32)

    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    splat_cuda.launches = 0
    timings = {}
    t0 = time.perf_counter()
    out = run_two_stage(m, image, PROMPT, depth=None,
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
        f"{timings['stage1_s']:.2f} s with the towers and the depth "
        f"estimate, render {timings['render_s']:.2f} s, stage 2 "
        f"{timings['stage2_s']:.2f} s for 2 trajectories), 11-trajectory "
        f"sweep {t2 - t1:.2f} s, peak memory {peak:.2f} GiB with the "
        f"towers resident, {tokens} tokens, {STEPS} steps per stage; "
        f"TeaCache calc/replay of the last stage-2 loop "
        f"{[c for _, _, c in m.inpaint_pipeline.teacache_state.log]}")
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    coords, colors = out["coords"], out["colors"]
    assert coords.shape == (FRAMES, H * W, 3), coords.shape
    # frame 0 is the cloud lifted from UniDepth's depth: finite, in front
    lifted_z = coords[0, :, 2]
    if not (torch.isfinite(lifted_z).all() and (lifted_z > 0).all()):
        raise AssertionError("the depth lift gave non-finite or "
                             "non-positive depths")
    log(f"main path depth lift: z of frame 0 in "
        f"[{lifted_z.min().item():.4f}, {lifted_z.max().item():.4f}]")
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
                   "stage1": lambda: stage1_generate(m, image, PROMPT)})
    return m, encoders, launches, stats


def stand_in_encoders(dit_cfg, seed, dev):
    """Stand-ins for the text, CLIP and OmniMAE towers in the train phase:
    each returns a fixed-seed tensor of the tower's real output shape (text
    [B, text_len, text_dim], CLIP [B, clip_tokens, clip_dim], MPM [B, 196,
    motion_feature_dim]) whatever its input."""
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


def stand_in_tokenize(prompts, vocab=256384, text_len=512):
    """The one stand-in left on the main path, for umT5's SentencePiece
    tokenizer (not in the repository): ids drawn from a seed made of the
    prompt, one a word, then the end token 1, padded with 0 to text_len."""
    import zlib

    ids = np.zeros((len(prompts), text_len), np.int64)
    mask = np.zeros((len(prompts), text_len), np.float32)
    for i, p in enumerate(prompts):
        n = min(len(p.split()), text_len - 1)
        rs = np.random.RandomState(zlib.crc32(p.encode()))
        ids[i, :n] = rs.randint(2, vocab, n)
        ids[i, n] = 1
        mask[i, :n + 1] = 1
    return ids, mask


TOWER_REL_TOL = 0.1     # a wrong path gives errors of order 1


def towers_phase(dev):
    """The four towers at full width with random weights from a seed,
    allocated on the card in bf16 as the JAX CLI casts its towers: umT5-xxl
    and CLIP ViT-H/14 compute in bf16; OmniMAE ViT-B and UniDepth-V2 in
    fp32 from their bf16 weights, as their JAX modules' dtype does. Each is
    timed on its main-path input (umT5 also on 2 full 512-token prompts,
    CLIP also on one 224 image), with its weights and its peak memory, and
    held to the same weights in fp32 computed with TF32 off: relative
    2-norm error under TOWER_REL_TOL."""
    import dataclasses

    import torch

    from more4d_tpu_torch.config import CLIPVisionConfig, T5Config
    from more4d_tpu_torch.models import (ClipVisionTower, UniDepthProvider,
                                         UniDepthV2, WanT5Encoder)
    from more4d_tpu_torch.models.clip import encode_image
    from more4d_tpu_torch.models.omnimae import (extract_mpm_features,
                                                 omnimae_vit)
    from more4d_tpu_torch.nn.layers import materialize

    gen = torch.Generator(dev).manual_seed(0)
    t5_cfg, clip_cfg = T5Config(), CLIPVisionConfig()
    makes = {
        "t5": lambda dt: WanT5Encoder(dataclasses.replace(t5_cfg, dtype=dt)),
        "clip": lambda dt: ClipVisionTower(dataclasses.replace(clip_cfg,
                                                               dtype=dt)),
        "omnimae": lambda dt: omnimae_vit("vit_base"),
        "unidepth": lambda dt: UniDepthV2(),
    }
    t0 = time.perf_counter()
    towers = {name: materialize(lambda: make(torch.bfloat16), dev,
                                torch.bfloat16, gen).eval()
              for name, make in makes.items()}
    torch.cuda.synchronize()
    log(f"towers: built in {time.perf_counter() - t0:.1f} s on the card in "
        f"bf16: " + ", ".join(
            f"{n} {sum(p.numel() for p in t.parameters()) / 1e9:.3f}e9 "
            f"params" for n, t in towers.items()))

    rs = np.random.RandomState(7)
    ids = torch.from_numpy(rs.randint(2, t5_cfg.vocab, (2, 512))).to(dev)
    full = torch.ones(2, 512, device=dev)
    image01 = torch.from_numpy(rs.rand(H, W, 3).astype(np.float32)).to(dev)
    renders = torch.from_numpy(rs.uniform(-1, 1, (2, H, W, 3)).astype(
        np.float32)).to(dev)
    img224 = torch.from_numpy(rs.uniform(-1, 1, (1, 224, 224, 3)).astype(
        np.float32)).to(dev)

    def runs(name, tower):
        if name == "t5":
            return {"2x512 tokens": lambda: tower(ids, full)}
        if name == "clip":
            return {"1 image 224": lambda: encode_image(tower, img224),
                    "2 renders 368x512": lambda: encode_image(tower,
                                                              renders)}
        if name == "omnimae":
            return {"1 image 368x512": lambda: extract_mpm_features(
                tower, image01[None])[0]}
        provider = UniDepthProvider(model=tower, device=dev)
        return {"368x512 (434x616 in)": lambda: provider(image01)}

    out = {}
    with torch.no_grad():
        for name, tower in towers.items():
            gib = sum(p.numel() * p.element_size()
                      for p in tower.parameters()) / 2 ** 30
            for case, fn in runs(name, tower).items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                got = fn()
                torch.cuda.synchronize()
                act = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
                ms = cuda_ms(fn, 5)
                out[f"{name} {case}"] = dict(ms=ms, weights_gib=gib,
                                             activation_peak_gib=act)
                log(f"towers: {name} {case}: {ms:.3f} ms, weights "
                    f"{gib:.3f} GiB, activation peak {act:.3f} GiB, output "
                    f"{tuple(got.shape)}")
                if not torch.isfinite(got.float()).all():
                    raise AssertionError(f"{name} {case}: non-finite output")
            # the same weights in fp32, TF32 off, on the first case's input
            case, fn = next(iter(runs(name, tower).items()))
            with torch.device("meta"):
                ref = makes[name](torch.float32)
            ref = ref.to_empty(device=dev)
            ref.load_state_dict(tower.state_dict())
            got = fn().float()
            with exact_fp32():
                want = next(iter(runs(name, ref.eval()).values()))().float()
            rel = ((got - want).norm() / want.norm()).item()
            out[f"{name} {case}"]["rel_err_vs_fp32"] = rel
            log(f"towers: {name} {case} against its weights in fp32 (TF32 "
                f"off): |out - fp32| / |fp32| {rel:.3e} (tol "
                f"{TOWER_REL_TOL})")
            del ref, want
            torch.cuda.empty_cache()
            if not rel < TOWER_REL_TOL:
                raise AssertionError(f"tower {name} in bf16 disagrees with "
                                     f"fp32: relative error {rel:.3e}")
        # device time against wall of each tower as the main path calls it
        profile_phase({"umT5 1x512": lambda: towers["t5"](ids[:1], full[:1]),
                       **{f"{n} {c}": fn for n in ("clip", "omnimae",
                                                   "unidepth")
                          for c, fn in list(runs(n, towers[n]).items())[-1:]}})
    return towers, out


def teacache_phase(dev, m, encoders):
    """TeaCache on the stage-1 denoise at the operating point: 12 steps,
    2 warm, threshold 0.10 and the 1.3B coefficients, on the towers'
    conditioning. Each step is timed (device synchronised) and its K1
    launches counted: a replay step must launch none, a calc step 90 (3 a
    block). If no step replays at 0.10, the loop runs again at twice the
    largest per-step polynomial value, where one must."""
    import torch

    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.infer.two_stage import grey_clip_image
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.pipelines import (TEACACHE_COEFFICIENTS,
                                            TeaCacheConfig,
                                            WanControlPipeline)

    base = m.control_pipeline
    cfg = base.dit.cfg
    g = torch.Generator(dev).manual_seed(11)
    lat = (1, (FRAMES - 1) // 4 + 1, H // 8, W // 8)
    latents = torch.randn(*lat, 16, device=dev, generator=g)
    y = torch.randn(*lat, cfg.in_dim - 16, device=dev, generator=g)
    image01 = torch.rand(1, H, W, 3, device=dev, generator=g)
    ctx = encoders.encode_text([PROMPT])
    neg = encoders.encode_text([""])
    clip = encoders.encode_clip(grey_clip_image(1, max(H, W), dev))
    mpm = encoders.extract_mpm(image01)
    coeffs = tuple(TEACACHE_COEFFICIENTS["wan2.1-fun-1.3b"])

    def run(thresh):
        pipe = WanControlPipeline(
            base.dit, base.vae, PipelineConfig(num_inference_steps=12,
                                               num_frames=FRAMES, height=H,
                                               width=W), dev,
            teacache=TeaCacheConfig(coeffs, thresh, 2))
        steps, step = [], pipe._step

        def timed(*a, **k):
            torch.cuda.synchronize()
            n0, t0 = flash_attention_cuda.launches, time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3,
                          flash_attention_cuda.launches - n0))
            return out

        pipe._step = timed
        out = pipe.denoise(latents, ctx, neg, y=y, clip_fea=clip,
                           mpm_features=mpm)
        log_ = pipe.teacache_state.log
        kinds = {True: [], False: []}
        for (ms, k1), (_, _, calc) in zip(steps, log_):
            kinds[calc].append(ms)
            want = 3 * cfg.num_layers if calc else 0
            if k1 != want:
                raise AssertionError(f"TeaCache at {thresh}: a "
                                     f"{'calc' if calc else 'replay'} step "
                                     f"launched {k1} K1, expected {want}")
        if not torch.isfinite(out).all():
            raise AssertionError("TeaCache denoise gave non-finite latents")
        res = dict(
            threshold=thresh, sequence="".join("C" if c else "r"
                                               for _, _, c in log_),
            rel=[r for r, _, _ in log_], poly=[p for _, p, _ in log_],
            k1_per_step=[k for _, k in steps],
            calc_ms=float(np.mean(kinds[True])),
            replay_ms=float(np.mean(kinds[False])) if kinds[False] else None,
            step_ms=[ms for ms, _ in steps])
        replay = ("none" if res["replay_ms"] is None
                  else f"{res['replay_ms']:.2f} ms")
        log(f"teacache at {thresh:.4g}: sequence {res['sequence']} (C calc, "
            f"r replay), K1 a step {res['k1_per_step']}, calc "
            f"{res['calc_ms']:.1f} ms a step, replay {replay} a step; rel "
            f"{[round(r, 5) for r in res['rel'][1:]]}, poly "
            f"{[round(p, 5) for p in res['poly'][1:]]}")
        return res

    runs = [run(0.10)]
    if "r" not in runs[0]["sequence"]:
        thresh = 2.0 * max(runs[0]["poly"][2:])
        runs.append(run(thresh))
        if "r" not in runs[1]["sequence"]:
            raise AssertionError(f"no TeaCache replay at {thresh}")
    return runs


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
    """The kind of a device kernel, by its name: the port's kernels
    (PORT_KERNELS), the foreach kernels of AdamW and the EMA, cuDNN convolutions (with their
    layout transposes), cuBLAS matmuls, PyTorch's dtype casts and copies,
    reductions, other elementwise kernels."""
    for sub, kind in PORT_KERNELS:
        if sub in name:
            return kind
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "optimizer and EMA (foreach)"
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


# ----------------------------------------------------------------- the CLI

CLI_STEPS = 3
CLI_TRAJECTORIES = "static,3"
LORA_WEIGHT = 0.55


def write_cli_checkpoints(root, dev, seed=0):
    """Synthetic checkpoints in the released layouts, written by the port's
    writer, random weights from ``seed`` at the 1.3B operating point's
    widths: the Control DiT as a released 3D checkpoint (48 input channels,
    no 4D groups) in bf16, in two ``diffusion_pytorch_model-0000k-of-00002
    .safetensors`` shards; the InP DiT as one bf16 ``.safetensors``; the
    Wan VAE as a ``.pth`` under ``model.``; the decoder adaptor as a
    ``.bin``; a rank-4 kohya ViSM LoRA with a non-zero up factor; CLIP
    under ``visual.``; the OmniMAE trunk with its patch conv spelt
    ``patch_embed.proj.*``; UniDepth carrying ``pixel_encoder.mask_token``.
    The DiTs' output heads are drawn N(0, 0.02) (zero at init). Returns
    {name: (path, bytes written)}."""
    import os

    import torch

    from more4d_tpu_torch import config as tcfg
    from more4d_tpu_torch.convert.lora_torch import save_kohya_lora
    from more4d_tpu_torch.models import (ClipVisionTower, UniDepthV2,
                                         VAEDecoderAdaptor, WanDiT, WanVAE)
    from more4d_tpu_torch.models.omnimae import omnimae_vit
    from more4d_tpu_torch.train.lora import create_lora
    from more4d_tpu_torch.utils.safetensors_io import save_file

    gen = torch.Generator(dev).manual_seed(seed)
    out = {}

    def size(path):
        if os.path.isdir(path):
            return sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
        return os.path.getsize(path)

    def cpu(module, dtype=None, prefix=""):
        return {prefix + k: (v if dtype is None else v.to(dtype)).cpu()
                for k, v in module.state_dict().items()}

    def dit(in_dim):
        with torch.device(dev):
            m = WanDiT(tcfg.dit_1_3b(motion_guidance=False, in_dim=in_dim,
                                     model_type="i2v")).init_weights(gen)
        with torch.no_grad():
            m.head.head.weight.normal_(0.0, 0.02, generator=gen)
        return cpu(m, torch.bfloat16)

    sd = dit(48)
    path = os.path.join(root, "control")
    os.makedirs(path)
    keys = sorted(sd)
    for i, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
        save_file({k: sd[k] for k in part}, os.path.join(
            path, f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"))
    out["control_dit"] = path
    sd = dit(36)
    out["inp_dit"] = os.path.join(root, "inp.safetensors")
    save_file(sd, out["inp_dit"])
    lora = create_lora(sd, torch.Generator().manual_seed(seed), rank=4)
    for f in lora["factors"].values():
        f["up"].normal_(0.0, 0.01, generator=torch.Generator().manual_seed(
            seed + 1))
    out["vism_lora"] = os.path.join(root, "vism_lora.safetensors")
    save_kohya_lora(out["vism_lora"], lora)
    del sd
    with torch.device(dev):
        vae = WanVAE(tcfg.VAEConfig()).init_weights(gen)
        towers = {"clip": ClipVisionTower(tcfg.CLIPVisionConfig()),
                  "omnimae": omnimae_vit("vit_base"), "unidepth": UniDepthV2()}
        for t in towers.values():
            t.init_weights(gen)
        dec = VAEDecoderAdaptor()
    for name, obj in (
            ("vae.pth", cpu(vae, prefix="model.")),
            ("decoder_adaptor.bin", cpu(dec)),
            ("clip.pth", cpu(towers["clip"], torch.bfloat16, "visual.")),
            ("omnimae.pth", {k.replace("patch_embed.proj.1.",
                                       "patch_embed.proj."): v
                             for k, v in cpu(towers["omnimae"]).items()}),
            ("unidepth.pth", {"state_dict": {
                **cpu(towers["unidepth"]),
                "pixel_encoder.mask_token": torch.zeros(
                    1, towers["unidepth"].pixel_encoder.embed_dim)}})):
        out[name.split(".")[0]] = os.path.join(root, name)
        torch.save(obj, out[name.split(".")[0]])
    del vae, towers, dec
    torch.cuda.empty_cache()
    return {k: (p, size(p)) for k, p in out.items()}


def cli_phase(dev, smi):
    """The port's CLI (``more4d_tpu_torch.scripts.infer``) on released-
    layout checkpoints at the 1.3B width: ``write_cli_checkpoints``, then
    the CLI's own ``load_models`` and ``run_sample`` with
    ``--model_size 1.3b --allow_dummy_text --sampler flow_dpm++
    --num_inference_steps 3 --trajectories static,3 --vism_lora ...
    --lora_weight 0.55`` (TeaCache at its default; no umT5 checkpoint or
    tokenizer exists, the towers phase covers umT5), and stage 1 again with
    ``flow_unipc`` on the weights already loaded. Fails unless the outputs
    are finite and of the CLI's shapes, the merged InP weights are the
    loaded ones plus 0.55 (alpha / r) up @ down to within bf16 rounding,
    the fresh FiLM is exactly zero, and K1 and K4 launched 90 a calc step
    and one a trajectory."""
    import dataclasses
    import tempfile

    import torch

    from more4d_tpu_torch.convert.lora_torch import load_vism_lora
    from more4d_tpu_torch.diffusion import get_scheduler
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda
    from more4d_tpu_torch.scripts import infer
    from more4d_tpu_torch.utils.safetensors_io import load_file

    stats = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ck = write_cli_checkpoints(root, dev)
        stats["write_s"] = time.perf_counter() - t0
        gib = {k: b / 2 ** 30 for k, (_, b) in ck.items()}
        log(f"cli: wrote the checkpoints in {stats['write_s']:.1f} s: "
            + ", ".join(f"{k} {v:.3f} GiB" for k, v in gib.items()))
        argv = ["--image", "unused.png", "--prompt", PROMPT,
                "--control_ckpt", ck["control_dit"][0],
                "--inp_ckpt", ck["inp_dit"][0], "--vae_ckpt", ck["vae"][0],
                "--decoder_adaptor", ck["decoder_adaptor"][0],
                "--clip_ckpt", ck["clip"][0], "--omnimae_ckpt",
                ck["omnimae"][0], "--depth_ckpt", ck["unidepth"][0],
                "--vism_lora", ck["vism_lora"][0],
                "--lora_weight", str(LORA_WEIGHT), "--model_size", "1.3b",
                "--allow_dummy_text", "--sampler", "flow_dpm++",
                "--num_inference_steps", str(CLI_STEPS),
                "--trajectories", CLI_TRAJECTORIES, "--height", str(H),
                "--width", str(W), "--num_frames", str(FRAMES),
                "--output_dir", root]
        args = infer.build_parser().parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        load_s = {}
        t0 = time.perf_counter()
        models = infer.load_models(args, dev, timings=load_s)
        torch.cuda.synchronize()
        stats["load_s"] = time.perf_counter() - t0
        log(f"cli: load_models {stats['load_s']:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in load_s.items())
            + f"; checkpoint sizes above) on {smi}")
        stats["load_by_checkpoint_s"] = load_s
        check_lora_merge(models, ck["inp_dit"][0], ck["vism_lora"][0],
                         load_file, load_vism_lora)
        check_fresh_film(models.control_pipeline.dit)

        rs = np.random.RandomState(3)
        image01 = rs.rand(H, W, 3).astype(np.float32)
        n_traj = len(infer.pick_trajectories(CLI_TRAJECTORIES))
        runs = {}
        for sampler in ("flow_dpm++", "flow_unipc"):
            if sampler == "flow_unipc":
                # stage 1 and the render again, on the loaded weights
                pipe = models.control_pipeline
                pipe.config = dataclasses.replace(pipe.config,
                                                  scheduler=sampler)
                pipe.scheduler = get_scheduler(sampler, CLI_STEPS,
                                               args.shift)
                args.sampler, args.run_stage2_complete = sampler, False
            flash_attention_cuda.launches = 0
            splat_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = infer.run_sample(models, image01, PROMPT, args,
                                   torch.Generator(dev).manual_seed(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_attention": flash_attention_cuda.launches,
                        "gs_splat": splat_cuda.launches}
            check_cli_outputs(out, n_traj, args.run_stage2_complete)
            pipes = [models.control_pipeline] + (
                [models.inpaint_pipeline] if args.run_stage2_complete else [])
            calc = [c for p in pipes for _, _, c in p.teacache_state.log]
            if not all(calc):
                # 3 steps are all TeaCache warm-up (5 warm steps)
                raise AssertionError(f"cli {sampler}: a step replayed")
            steps = CLI_STEPS * (1 + (n_traj if args.run_stage2_complete
                                      else 0))
            want = {"flash_attention": 3 * models.control_pipeline.dit.cfg
                    .num_layers * steps, "gs_splat": n_traj}
            log(f"cli {sampler}: run_sample {wall:.2f} s (stage 1 "
                f"{out['timings']['stage1_s']:.2f} s, render "
                f"{out['timings']['render_s']:.2f} s, stage 2 "
                f"{out['timings']['stage2_s']:.2f} s); launches "
                f"{launches}, expected {want} (K1 90 a CFG-doubled calc "
                f"step, {steps} steps; K4 one a trajectory); TeaCache "
                f"calc steps of the last loops {calc}; on {smi}")
            if launches != want:
                raise AssertionError(f"cli {sampler}: launches {launches}, "
                                     f"expected {want}")
            runs[sampler] = dict(out["timings"], run_sample_s=wall,
                                 launches=launches)
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"cli: peak memory {stats['peak_gib']:.2f} GiB (two 1.3B DiTs, "
            f"the VAE, CLIP, OmniMAE and UniDepth resident) on {smi}")
        stats["runs"] = runs
        del models, out
    torch.cuda.empty_cache()
    return stats


def check_lora_merge(models, inp_path, lora_path, load_file, load_vism_lora):
    """The InP DiT's merged weights against the checkpoint's plus
    LORA_WEIGHT (alpha / r) up @ down, computed here in fp32: equal to
    within one bf16 rounding of the sum (the CLI merges on the host in
    fp32 and rounds once to bf16: one bf16 ulp, 2^-7 relative, covers that
    rounding and the two fp32 sums' order), and different from the loaded
    weights."""
    import torch

    dit = models.inpaint_pipeline.dit
    own = dict(dit.named_parameters())
    base = load_file(inp_path)
    lora = load_vism_lora(lora_path)
    scale = LORA_WEIGHT * lora["alpha"] / lora["rank"]
    worst, moved = 0.0, 0
    for name, f in lora["factors"].items():
        dev = own[name].device
        want = base[name].to(dev).float() + scale * (
            f["up"].to(dev) @ f["down"].to(dev))
        got = own[name].float()
        err = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
        worst = max(worst, err)
        moved += int((got != base[name].to(dev).float()).any())
    log(f"cli: ViSM LoRA merged into {len(lora['factors'])} InP weights "
        f"(rank {lora['rank']}, alpha {lora['alpha']}, weight "
        f"{LORA_WEIGHT}): max |merged - (loaded + delta)| / |.| {worst:.3e} "
        f"(tol one bf16 ulp, {2 ** -7:.3e}); {moved} weights moved")
    if not (worst <= 2 ** -7 and moved == len(lora["factors"])):
        raise AssertionError(f"LoRA merge: relative error {worst:.3e}, "
                             f"{moved}/{len(lora['factors'])} weights moved")


def check_fresh_film(dit):
    """The 4D groups the 3D Control checkpoint lacks: the FiLM exactly
    zero, the feature adapter's xavier convs not; the patch embedding's
    16 new depth channels zero."""
    film = {n: p for n, p in dit.named_parameters()
            if ".spatial_guidance_" in n}
    nonzero = [n for n, p in film.items() if p.any()]
    adapter = dit.feature_adapter[0].weight
    depth_ch = dit.patch_embedding.weight[:, 48:]
    log(f"cli: fresh 4D groups: {len(film)} FiLM tensors, {len(nonzero)} "
        f"non-zero; feature adapter max |w| "
        f"{adapter.abs().max().item():.4f}; patch embedding "
        f"{tuple(dit.patch_embedding.weight.shape)}, new channels max |w| "
        f"{depth_ch.abs().max().item()}")
    if nonzero or depth_ch.any() or not adapter.any():
        raise AssertionError(f"fresh init: non-zero FiLM {nonzero[:4]}, or "
                             f"depth channels non-zero, or a zero adapter")


def check_cli_outputs(out, n_traj, stage2):
    import torch

    coords, colors = out["coords"], out["colors"]
    if coords.shape != (FRAMES, H * W, 3) or colors.shape != (H * W, 3):
        raise AssertionError(f"cli clouds {tuple(coords.shape)}, "
                             f"{tuple(colors.shape)}")
    if not (torch.isfinite(coords).all() and torch.isfinite(colors).all()):
        raise AssertionError("cli: non-finite clouds")
    if len(out["renders"]) != n_traj:
        raise AssertionError(f"cli: {len(out['renders'])} renders")
    for r in out["renders"]:
        if r["frames"].shape != (FRAMES, H, W, 3) or not torch.isfinite(
                r["frames"]).all():
            raise AssertionError(f"cli render {r['name']}")
    if len(out["videos"]) != (n_traj if stage2 else 0):
        raise AssertionError(f"cli: {len(out['videos'])} videos")
    for v in out["videos"]:
        x = v["video"]
        if x.shape != (FRAMES, H, W, 3) or not torch.isfinite(x).all() \
                or x.min() < 0 or x.max() > 1:
            raise AssertionError(f"cli video {v['name']}: {tuple(x.shape)}")


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
    import gc

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
    ptxas = {}
    for name in secs:
        path = _build.log_path(name)
        if not path.exists():
            log(f"  ptxas {name}: no nvcc log beside its library")
            continue
        for kernel, info in ptxas_summary(path.read_text()).items():
            log(f"  ptxas {name}: {kernel}: {info}")
            ptxas[kernel] = info

    def regs(kernel):
        return ptxas.get(kernel, f"{kernel}: not in any nvcc log")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    k1, k1_err, k1_tol = flash_phase(dev)
    bwd = flash_bwd_phase(dev)
    k4, k4_err, k4_tol = splat_phase(dev)
    towers, tower_stats = towers_phase(dev)
    m, encoders, launches, stats = main_path(dev, towers)
    teacache = teacache_phase(dev, m, encoders)
    del m, encoders, towers
    gc.collect()
    torch.cuda.empty_cache()
    cli = cli_phase(dev, smi)
    cli_launches = cli["runs"]["flow_dpm++"]["launches"]
    train_launches, train_stats = train_phase(dev)
    stats.update(train_stats)
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
            ptxas=regs(f"flash_bwd_{kind}_kernel<128>"),
            **({} if kind == "dq" else dict(
                ptxas_reduce=regs("dkv_reduce_kernel"))),
            cases={c: dict(ms=v[f"ms_{kind}"], bound_ms=v[f"bound_ms_{kind}"],
                           tflops=v[f"tflops_{kind}"],
                           plain_ms=v["plain_ms"],
                           library_ms=v["library_ms"],
                           errors={g: v["errors"][g] for g in grads},
                           **({} if kind == "dq" else dict(
                               splits=v["splits"],
                               ms_unsplit=v["ms_dkv_unsplit"])))
                   for c, v in bwd.items()})

    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="more4d_tpu_torch/csrc/flash_attention.cu",
             replaces="more4d_tpu/kernels/flash_attention.py:48",
             launches=launches["flash_attention"],
             launches_by_path={"run_two_stage": launches["flash_attention"],
                               "cli": cli_launches["flash_attention"],
                               "train": train_launches["flash_attention"]},
             launches_by_teacache_step={
                 f"{r['threshold']:.4g}": dict(zip(r["sequence"],
                                                   r["k1_per_step"]))
                 for r in teacache},
             max_abs_err=k1_err,
             tolerance=k1_tol, ms=sa["ms"], plain_ms=sa["plain_ms"],
             bound_ms=sa["bound_ms"], bound_by=sa["bound_by"],
             library_ms=sa["library_ms"],
             shape="self-attention q/k/v [2,9568,12,128] bf16",
             ptxas=regs("flash_fwd_kernel<128>"),
             cases={k: {kk: vv for kk, vv in v.items()
                        if kk not in ("flops", "bytes")}
                    for k, v in k1.items()}),
        bwd_entry("dq", ("dq",), 216),
        bwd_entry("dkv", ("dk", "dv"), 250),
        dict(name="gs_splat", route="cuda",
             source="more4d_tpu_torch/csrc/gs_splat.cu",
             replaces="more4d_tpu/kernels/gs_splat.py:121",
             launches=launches["gs_splat"],
             launches_by_path={"run_two_stage": launches["gs_splat"],
                               "cli": cli_launches["gs_splat"]},
             max_abs_err=k4_err,
             tolerance=k4_tol, ms=fr["ms"], plain_ms=fr["plain_ms"],
             bound_ms=fr["bound_ms"], bound_by=fr["bound_by"],
             library_ms=None, ptxas=regs("splat_kernel<3>"),
             shape="one trajectory: 49 frames of 368x512, 188,416 points, "
                   "736 tiles x 512 records",
             cases={k: {kk: vv for kk, vv in v.items()
                        if kk in ("ms", "plain_ms", "bound_ms",
                                  "max_abs_err", "tile_records_ms")}
                    for k, v in k4.items()}),
    ]
    log("main path stats: " + json.dumps(
        {k: round(v, 4) for k, v in stats.items()}))
    log("towers: " + json.dumps(tower_stats))
    log("teacache: " + json.dumps(teacache))
    log(f"cli on {smi}: " + json.dumps(cli))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
