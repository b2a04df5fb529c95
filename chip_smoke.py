#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``more4d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each fatal on failure (K5's
launches are counted on every path beside K1's: 8 for every 3 of K1
without a gradient; in a full fine-tune 8 of K5's backward for every 3 of
K2 and twice as many of K5, each block's norms running in its forward
and again in its run in the backward; a LoRA step's are counted and not
held to a number):

1. build the hand-written kernels from ``more4d_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it (K1 the forward at the inference and training
   batches, K2/K3 the attention backward at the 1.3B's 12 heads and the
   14B's 40, K4 the splat, K5 and its backward each norm site of a DiT
   block at both widths, and a full-width block's K5 launches without a
   gradient and with one; K6 the fp8 widening at the 14B's matrix shapes,
   to bf16 and to fp32, then its launches a forward, one a fp8 tensor, on
   the 14B's fp8 and streamed paths, and none on the 1.3B and fine-tune
   paths; on every path after, K6 held to the fp8 tensors of the modules
   called, ``k6_check``), reject faults
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
   a replay step must launch no K1 and no K5, a calc step 90 K1 and 240
   K5; the loop that
   replayed again with the residual in pinned host memory, the same bits;
   then the ViSM LoRA CLI (``more4d_tpu_torch.scripts.train_vism``) at
   1.3B on the towers' umT5 and CLIP (``vism_train_phase``): its samples
   made by ``prepare_vism_sample``'s z-buffer behind ``prefetch``, 3
   AdamW steps with the kohya export (loaded back and merged), 2
   micro-steps of CAME with grad_accum_steps 2, 2 steps of
   ``--train_text_encoder``; K1-K3 must launch, the factors move, the
   factor gradients agree with the plain attention's; one step profiled;
6. the CLI (``more4d_tpu_torch.scripts.infer``) on synthetic released-
   layout checkpoints of the 1.3B width written by the port's writer
   (``cli_phase``, after phase 7, which reads the same files): its ``load_models`` (sharded bf16 safetensors with the
   48->64 surgery, the kohya ViSM LoRA merged at 0.55, the towers and
   UniDepth from torch files) and ``run_sample`` with DPM++ for 3 steps a
   stage and 2 trajectories, then stage 1 again with UniPC; outputs, the
   merge, the fresh FiLM and K1/K4's launch counts are checked;
   then the CLI again with ``--fp8_weights`` and with ``--offload_blocks``
   and stage 2's options (both with ``--teacache_offload``);
7. the 4D-STraG training CLI (``more4d_tpu_torch.scripts.train_straag``,
   ``straag_cli_phase``, before the towers are dropped) at the 1.3B, 49
   frames of 368x512, on the towers' umT5, CLIP and OmniMAE: its
   ``run_training`` for 3 AdamW steps (remat 'nothing', K1 180 a step,
   K2 and K3 90, K5 480 and its backward 240; params and EMA move; the
   DiT's gradients against the plain attention; a step and its batch
   preparation profiled), 2 steps
   under each of 'flash_lite', 'flash' and 'flash_offload' (the same
   losses and grad norms bit for bit, K1 150 a step), 2 micro-steps of
   ``--grad_accum_steps 2 --report_model_info``, one step with a
   20-step validation sample; then its ``main(argv)`` on the synthetic
   checkpoints and scene-flow pickles, 2 steps with a checkpoint and a
   resumed third;
8. the 14B (``dit14b_phase``): both DiTs' blocks made from a seed into
   pinned host memory in fp8, streamed through ``StreamedDiT``; the DiT
   against the plain attention, one CFG-doubled step streamed and with
   its blocks resident in fp8 (the same bits), TeaCache replays streamed
   and resident (the same bits, the residual kept and offloaded), the
   block copies alone, then ``run_two_stage`` through the streamed
   pipelines (K1 120 a calc step); the ViSM CLI's ``--offload_blocks``
   path on the InP DiT's pinned blocks for 3 steps (``vism14b_phase``: K1
   240, K2 120 and K3 120 a step; 3 steps with its blocks resident, for
   the overlap share and held to the streamed steps bit for bit; on 3
   full-width blocks the streamed step against the resident LoRA step and
   against itself with ``acts_on_host``); then
   ``run_two_stage`` again with both DiTs resident on the card as
   ``--fp8_weights`` quantizes them;
9. the VAE-adaptor CLI's ``run_training`` at its defaults (17 frames of
   384x512, decoder fine-tuned, gradient checkpointing) for 3 steps
   (``vae_train_phase``);
10. the device mesh (``parallel_phase``): K1 at the shapes a rank gives
   it under ``--sp`` (H/S heads over the whole sequence, L/S queries
   against the text and CLIP keys); two ranks spawned on the one card
   with ``create_mesh(backend="gloo")`` (NCCL refuses two ranks on one
   device), each held to 0.47 of its memory: the 1.3B CFG-doubled step
   and ``run_two_stage`` under ``--sp 2`` and under ``--fsdp``, the
   data-parallel sweep, and the STraG CLI's ``run_training`` under
   ``--mesh fsdp=2`` and ``--mesh data=2``, each held against the same
   work in a fresh process (and a data=2 run whose gradients are summed
   over the ranks, not averaged, which the check must reject), and
   ``--mesh fsdp=2 --optimizer came`` (CAME's factored moments on the
   shards); one NCCL rank under ``--mesh fsdp=-1``. Their walls are
   logged as walls, not as the mesh's speed;
11. the memory modes on the mesh (``mesh_memory_phase``, after phase 6,
   on its files): on two gloo ranks, the 14B 4D-STraG DiT's CFG-doubled
   step at full width and 40 layers from seeds, sharded as ``infer --fsdp
   --fp8_weights``, ``--fsdp --offload_blocks`` and ``--sp 2
   --offload_blocks`` shard it, each held to the same step in the same
   mode without the mesh in a fresh process, K1 on every rank;
   then ``infer.main`` at 1.3B under ``--fsdp --fp8_weights`` and
   ``--fsdp --offload_blocks`` (K1 and K4 on every rank);
12. print the kernels line, the card's name and power limit, and the
   device line last.

Exits non-zero without a result when CUDA is unavailable or the package is
not beside this script.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
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
                ("splat_kernel", "K4 gs_splat"),
                ("more4d_rownorm_kernel", "K5 rownorm"),
                ("more4d_rownorm_bwd_kernel", "K5 rownorm backward"),
                ("more4d_rownorm_bwd_sum_kernel", "K5 rownorm backward"),
                ("more4d_widen_fp8_kernel", "K6 widen_fp8"))


def ptxas_summary(text):
    """{kernel: "registers, spills, notes"} for each entry function in an
    ``nvcc -Xptxas -v`` log: the kernel named by its PORT_KERNELS
    substring with its integer and bool template arguments (``<128>``,
    ``<4,1>``, ``<4,1,0>``); its spills and any ptxas warning that follows
    it (such as serialised wgmma) kept."""
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
            args = re.findall(r"L[ib](\d+)E", mangled)
            kernel += f"<{','.join(args)}>" if args else ""
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
    (the CFG-doubled batch 2 of inference, batch 1 of training; 12 heads at
    1.3B, 40 at 14B). Each case also plants the faults the comparison must
    catch, by giving the kernel the kv-lengths a faulty kernel would use:
    its last key tile (of the size its library reports) dropped, and row
    0's kv-length used for every row."""
    import torch

    from more4d_tpu_torch.kernels.flash_attention import flash_fwd_tiles

    L = 9568
    block_q, block_k = flash_fwd_tiles()
    log(f"K1 tiles: {block_q} q rows a CTA, {block_k} keys a tile")
    cases = [("self", 2, L, L, [L, L], 12), ("self_b1", 1, L, L, [L], 12),
             ("self_short_kv", 2, L, L, [L, 7000], 12),
             ("cross_text", 2, L, 512, None, 12),
             ("cross_clip", 2, L, 257, None, 12),
             ("ragged_17_9", 2, 17, 9, [9, 5], 12),
             ("ragged_40_24", 2, 40, 24, [24, 11], 12),
             ("self_14b", 2, L, L, [L, L], 40),
             ("self_short_kv_14b", 2, L, L, [L, 7000], 40),
             ("cross_text_14b", 2, L, 512, None, 40),
             ("cross_clip_14b", 2, L, 257, None, 40)]
    gen = torch.Generator(dev).manual_seed(0)
    out = {}
    for name, b, lq, lk, lens, h in cases:
        out[name] = k1_case(dev, gen, name, b, lq, lk, lens, h)
    worst = max(out.values(),
                key=lambda c: c["max_abs_err"] / c["tolerance"])
    return out, worst["max_abs_err"], worst["tolerance"]


def k1_case(dev, gen, name, b, lq, lk, lens, h, d=128):
    """K1 on q [b, lq, h, d], k and v [b, lk, h, d] bf16 from ``gen``
    (``lens`` the kv-lengths, or None) against its plain version with
    TF32 off, the planted faults rejected, then timed beside the plain
    version and SDPA: the case's errors, tolerances and times."""
    import torch
    import torch.nn.functional as F

    from more4d_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain, flash_fwd_tiles)

    block_q, block_k = flash_fwd_tiles()
    q = torch.randn(b, lq, h, d, device=dev, generator=gen).bfloat16()
    k = torch.randn(b, lk, h, d, device=dev, generator=gen).bfloat16()
    v = torch.randn(b, lk, h, d, device=dev, generator=gen).bfloat16()
    kv = (None if lens is None else
          torch.tensor(lens, dtype=torch.int32, device=dev))

    def plain():
        # per batch row and 12 heads at a time, so the [H, Lq, Lk] fp32
        # scores stay ~4 GB; lse rows are (batch, head) in order
        os, lses = [], []
        for i in range(b):
            parts = [flash_attention_plain(
                q[i:i + 1, :, h0:h0 + 12], k[i:i + 1, :, h0:h0 + 12],
                v[i:i + 1, :, h0:h0 + 12],
                None if kv is None else kv[i:i + 1])
                for h0 in range(0, h, 12)]
            os.append(torch.cat([o for o, _ in parts], dim=2))
            lses += [s for _, s in parts]
        return torch.cat(os), torch.cat(lses)

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
    out = dict(max_abs_err=err, tolerance=tol, rel_err=rel,
                     tolerance_rel=REL_TOL, max_abs_err_lse=err_lse,
                     tolerance_lse=LSE_TOL,
                     planted_faults=caught, ms=ms, plain_ms=plain_ms,
                     library_ms=lib_ms, bound_ms=bms, bound_by=by,
                     flops=flops, bytes=nbytes)
    log(f"K1 {name:14s} kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {h} heads, "
        f"{b * h * -(-lq // block_q)} q tiles")
    del q, k, v
    torch.cuda.empty_cache()
    return out


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

    d, L = 128, 9568
    block_k = flash_fwd_tiles()[1]
    cases = [("self", 1, L, L, [L], 12),
             ("self_short_kv", 2, L, L, [L, 7000], 12),
             ("cross_text", 1, L, 512, None, 12),
             ("cross_clip", 1, L, 257, None, 12),
             ("ragged_17_9", 2, 17, 9, [9, 5], 12),
             ("ragged_40_24", 2, 40, 24, [24, 11], 12),
             # the 14B's 40 heads, as its LoRA step runs them
             ("self_40h", 1, L, L, [L], 40),
             ("cross_text_40h", 1, L, 512, None, 40),
             ("cross_clip_40h", 1, L, 257, None, 40)]
    gen = torch.Generator(dev).manual_seed(3)
    out = {}
    for name, b, lq, lk, lens, h in cases:
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
            # per batch row and at most 12 heads, so the [H, Lq, Lk] fp32
            # intermediates stay ~4.4 GB each
            rows = []
            for i in range(b):
                lse_i = lse[i * h:(i + 1) * h]
                parts = [flash_attention_bwd_plain(
                    q[i:i + 1, :, j:j + 12], k[i:i + 1, :, j:j + 12],
                    v[i:i + 1, :, j:j + 12],
                    None if kv is None else kv[i:i + 1],
                    o[i:i + 1, :, j:j + 12], lse_i[j:j + 12],
                    do[i:i + 1, :, j:j + 12]) for j in range(0, h, 12)]
                rows.append(tuple(torch.cat(t, dim=2) for t in zip(*parts)))
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
        out[name]["heads"] = h
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


# ----------------------------------------------------------------------- K5

ROWNORM_TOKENS = 9568          # 13 x 23 x 32: 49 frames of 368x512
ROWNORM_GRID = (13, 23, 32)
ROWNORM_WIDTHS = {"1.3b": (1536, 30), "14b": (5120, 40)}   # dim, layers
# K5's launches a run of a DiT block (2 film or modulate, 1 affine, 2
# rope, 3 rms), where K1 launches 3; under a gradient as many in each run
# of the block (the forward and, rematerialised, the backward's) and as
# many of K5's backward, where K2 launches 3
K5_PER_BLOCK = 8
K5_EPILOGUES = {}      # {path: K5's launches by epilogue}, in this process


def k5_check(path, launches, grad=False, epilogues=True):
    """``launches`` (K5's under "rownorm" and its backward's under
    "rownorm_bwd", counted from zero with K1's and K2's) held to them: on a
    path without a gradient K5_PER_BLOCK for every 3 of K1 and no backward;
    on one with (training, every block rematerialised) K5_PER_BLOCK
    backward launches for every 3 of K2 and twice as many forward ones;
    with ``epilogues``, K5's counts by epilogue, counted from zero in this
    process, kept under ``path``."""
    from more4d_tpu_torch.kernels.rownorm import rownorm_cuda

    k1, k5 = launches["flash_attention"], launches["rownorm"]
    k5_bwd = launches.get("rownorm_bwd", 0)
    if grad:
        k2 = launches["flash_attention_bwd_dq"]
        want = (2 * K5_PER_BLOCK * k2 // 3, K5_PER_BLOCK * k2 // 3)
        ok = k2 % 3 == 0 and k5_bwd > 0
        rule = (f"K2 {k2}: {K5_PER_BLOCK} backward for every 3 of K2 and "
                f"twice as many forward")
    else:
        want = (K5_PER_BLOCK * k1 // 3, 0)
        ok = k1 % 3 == 0 and k5 > 0
        rule = f"{K5_PER_BLOCK} for every 3 of K1 and no backward"
    if (k5, k5_bwd) != want or not ok:
        raise AssertionError(
            f"{path}: K5 {k5} launches and {k5_bwd} of its backward with K1 "
            f"{k1}, expected {want} ({rule})")
    if epilogues:
        K5_EPILOGUES[path] = {e: n for e, n in
                              sorted(rownorm_cuda.epilogues.items()) if n}


def rownorm_oracle(epilogue, x, kw, eps=1e-6):
    """The chain in fp64 from the same bf16 operands, rounded nowhere but
    where it must round: the norm before RoPE."""
    import torch

    xd = x.double()
    if epilogue in ("rms", "rope"):
        y = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + eps)
        y = y * kw["weight"].double()
        if epilogue == "rms":
            return y
        y = y.to(torch.bfloat16).double()
        b, l, d = y.shape
        hd = 2 * kw["cos"].shape[-1]
        yr = y.reshape(b, l, d // hd, hd // 2, 2)
        c = kw["cos"].double()[None, :, None]
        s = kw["sin"].double()[None, :, None]
        ye, yo = yr[..., 0], yr[..., 1]
        return torch.stack([ye * c - yo * s, ye * s + yo * c],
                           -1).reshape(b, l, d)
    mean = xd.mean(-1, keepdim=True)
    n = (xd - mean) * torch.rsqrt((xd - mean).square().mean(-1, keepdim=True)
                                  + eps)
    if epilogue == "affine":
        return n * kw["weight"].double() + kw["bias"].double()
    h = n * (1 + kw["scale"].double()) + kw["shift"].double()
    if "film" not in kw:
        return h
    params, mask, gate = (None if t is None else t.double()
                          for t in kw["film"])
    if mask is not None:
        params = params * mask[None]
    sc, sh = params.chunk(2, -1)
    return h * (1 + sc * gate) + sh * gate


def rownorm_errors(got, want, oracle):
    """K5's output ``got`` and the eager chain's ``want`` against the fp64
    ``oracle``: {max |K5 - eager| in bf16 ulps of the largest |eager|,
    max |K5 - oracle|, max |eager - oracle|, both 2-norms}, and whether K5
    is no farther from the oracle than the eager chain: its 2-norm within
    1% (the order of the sums) and its largest error within one rounding
    flip (a bf16 ulp of the largest |oracle|) of the eager chain's. Over
    ~29 million elements the eager FiLM chain's own roundings reach 3
    ulps of the largest |out| here; the kernel rounds once."""
    top = want.float().abs().max().item()
    k, e = got.double() - oracle, want.double() - oracle
    r = dict(ulps_vs_eager=(got.float() - want.float()).abs().max().item()
             / bf16_ulp(top),
             max_err=k.abs().max().item(), eager_max_err=e.abs().max().item(),
             norm_err=k.norm().item(), eager_norm_err=e.norm().item())
    ok = (r["norm_err"] <= 1.01 * r["eager_norm_err"]
          and r["max_err"] <= r["eager_max_err"]
          + bf16_ulp(oracle.abs().max().item()))
    return r, ok


def rownorm_sites(dev, d, seed=0, b=2):
    """K5's launches in a DiT block at width ``d`` over ``b`` x 9,568
    tokens (2: the main path's CFG-doubled batch; 1: the fine-tune's):
    {site: (epilogue, x, operands, bytes moved)}; the bytes count each row
    read once and written once, and the RoPE rows once."""
    import torch

    from more4d_tpu_torch.nn.rope import RopeTables, rope_angles_3d

    g = torch.Generator(dev).manual_seed(seed)

    def r(*shape, s=1.0, m=0.0):
        return torch.randn(*shape, device=dev, generator=g) * s + m

    l = ROWNORM_TOKENS
    row = b * l * d * 2
    x = r(b, l, d, s=3.0, m=0.5).bfloat16()
    w = r(d, s=0.2, m=1.0)
    cos, sin = rope_angles_3d(RopeTables.create(128), ROWNORM_GRID,
                              seq_len=l, device=dev)
    film = (r(b, l, 2 * d, s=0.5).bfloat16(),
            torch.ones(l, 1, device=dev), r(d, s=0.5).bfloat16())
    mod = dict(shift=r(b, 1, d, s=0.3).bfloat16(),
               scale=r(b, 1, d, s=0.3).bfloat16())
    ctx = r(b, 512, d, s=3.0).bfloat16()
    return {
        "adaln_film": ("film", x, dict(film=film, **mod), 4 * row),
        "norm3": ("affine", x, dict(weight=w, bias=r(d, s=0.2)), 2 * row),
        "self_qk_rope": ("rope", x, dict(weight=w, cos=cos, sin=sin),
                         2 * row + 2 * cos.numel() * 4),
        "cross_q": ("rms", x, dict(weight=w), 2 * row),
        "text_k": ("rms", ctx, dict(weight=w), 2 * ctx.numel() * 2),
    }


def rownorm_block(dev, key, b=2):
    """One full-width 4D-STraG block (i2v, bf16, weights from a seed, FiLM
    and gates non-zero) and its inputs at the operating point, ``b``
    samples (2: CFG-doubled): (block, args)."""
    import torch

    from more4d_tpu_torch.config import dit_1_3b, dit_14b
    from more4d_tpu_torch.models.wan_dit import WanBlock
    from more4d_tpu_torch.nn.rope import RopeTables, rope_angles_3d

    cfg = (dit_1_3b if key == "1.3b" else dit_14b)(motion_guidance=True)
    g = torch.Generator(dev).manual_seed(7)
    with torch.device(dev):
        blk = WanBlock(cfg).to(torch.bfloat16)
    blk.requires_grad_(False)
    for p in blk.parameters():
        p.normal_(0.0, p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1,
                  generator=g)
    for m in blk.modules():
        if hasattr(m, "eps") and hasattr(m, "weight"):
            m.weight.add_(1.0)            # norm scales near 1
    l, d = ROWNORM_TOKENS, cfg.dim
    cos, sin = rope_angles_3d(RopeTables.create(cfg.head_dim), ROWNORM_GRID,
                              seq_len=l, device=dev)
    args = (torch.randn(b, l, d, device=dev, generator=g).bfloat16(),
            torch.randn(b, 6, d, device=dev, generator=g) * 0.1,
            torch.randn(b, cfg.text_len + cfg.clip_tokens, d, device=dev,
                        generator=g).bfloat16(),
            cos, sin, torch.full((b,), l, dtype=torch.int32, device=dev),
            torch.randn(b, l, cfg.motion_feature_dim, device=dev,
                        generator=g).bfloat16(),
            torch.ones(l, 1, device=dev))
    return blk, args


def rownorm_phase(dev):
    """K5 at both widths (1.3B 1536, 14B 5120) over the CFG-doubled batch
    of 9,568 tokens: each site of a DiT block against the eager chain it
    replaces (its plain version), timed beside it and beside its bound;
    then one full-width block without a gradient, its K5 launches counted
    (8: 2 film, 1 affine, 2 rope, 3 rms) and timed against the same block
    with the eager chains. Returns {width: {site: stats}, "block": ...}."""
    import torch

    from more4d_tpu_torch.kernels import rownorm

    out = {}
    for key, (d, _) in ROWNORM_WIDTHS.items():
        sites = {}
        for site, (epi, x, kw, nbytes) in rownorm_sites(dev, d).items():
            got = rownorm.rownorm_cuda(epi, x, 1e-6, **kw)
            want = rownorm.rownorm_plain(epi, x, 1e-6, **kw)
            errs, ok = rownorm_errors(got, want, rownorm_oracle(epi, x, kw))
            if not ok:
                raise AssertionError(f"K5 {key} {site}: farther from the "
                                     f"fp64 oracle than the eager chain: "
                                     f"{errs}")
            ms = cuda_ms(lambda: rownorm.rownorm_cuda(epi, x, 1e-6, **kw),
                         50, warmup=3)
            plain_ms = cuda_ms(lambda: rownorm.rownorm_plain(epi, x, 1e-6,
                                                             **kw), 10)
            bms, by = bound_ms(nbytes, 0, BF16_FLOPS)
            sites[site] = dict(epilogue=epi, shape=list(x.shape), **errs,
                               ms=ms, plain_ms=plain_ms, bound_ms=bms,
                               bound_by=by, roofline=bms / ms)
            log(f"K5 {key} {site:12s} {epi:6s} {tuple(x.shape)}: "
                f"|K5 - eager| {errs['ulps_vs_eager']:.1f} ulps; vs fp64 "
                f"max {errs['max_err']:.3e} (eager {errs['eager_max_err']:.3e})"
                f", 2-norm {errs['norm_err']:.3e} (eager "
                f"{errs['eager_norm_err']:.3e}) | kernel {ms:.4f} ms, eager "
                f"chain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                f"{bms / ms:.3f} of it")
            del got, want
        blk, args = rownorm_block(dev, key)
        n0, by0 = rownorm.rownorm_cuda.launches, dict(
            rownorm.rownorm_cuda.epilogues)
        with torch.no_grad():
            fast = blk(*args)
        launches = rownorm.rownorm_cuda.launches - n0
        per_epi = {e: n - by0.get(e, 0)
                   for e, n in rownorm.rownorm_cuda.epilogues.items()
                   if n - by0.get(e, 0)}
        if per_epi != dict(film=2, affine=1, rope=2, rms=3):
            raise AssertionError(f"K5 {key} block: launches {per_epi}, "
                                 f"expected 2 film, 1 affine, 2 rope, 3 rms")
        with torch.no_grad():
            block_ms = cuda_ms(lambda: blk(*args), 5)
            saved = rownorm._route
            rownorm._route = lambda *a: rownorm.PLAIN
            try:
                eager = blk(*args)
                eager_ms = cuda_ms(lambda: blk(*args), 5)
            finally:
                rownorm._route = saved
        rel = ((fast.float() - eager.float()).norm()
               / eager.float().norm()).item()
        if not rel < 1e-2:
            raise AssertionError(f"K5 {key} block: |K5 - eager| / |eager| "
                                 f"{rel:.3e}")
        sites["block"] = dict(launches=launches, by_epilogue=per_epi,
                              ms=block_ms, eager_ms=eager_ms, rel_err=rel)
        log(f"K5 {key} block: {launches} launches ({per_epi}); "
            f"block {block_ms:.3f} ms with K5, {eager_ms:.3f} ms with the "
            f"eager chains; |K5 - eager| / |eager| {rel:.2e}")
        out[key] = sites
        del blk, args, fast, eager
        torch.cuda.empty_cache()
    return out


def rownorm_bwd_bytes(epilogue, x, kw):
    """Bytes K5's backward must move at a site: x and dy read and dx
    written (a [B, L, D] bf16 tensor each), the FiLM projection read and
    its gradient written, the RoPE rows read; the column sums' few
    vectors left out."""
    row = x.numel() * 2
    extra = 4 * row if epilogue == "film" else 0
    if epilogue == "rope":
        extra = 2 * kw["cos"].numel() * 4
    return 3 * row + extra


def rownorm_grad_errors(got, eager, oracle):
    """K5's backward's gradients ``got`` and autograd's of the eager chain
    against the fp64 ``oracle``, each 2-norm: {name: (K5's error, the
    eager chain's)}, and whether K5's is no farther (within 1% for the
    order of the sums, and 1e-5 of the oracle's norm for an fp32
    gradient, where both sides sit at fp32 rounding)."""
    import torch

    errs, ok = {}, True
    for name, o in oracle.items():
        ke = (got[name].double() - o).norm().item()
        ee = (eager[name].double() - o).norm().item()
        floor = (1e-5 * o.norm().item()
                 if got[name].dtype == torch.float32 else 0.0)
        errs[name] = (ke, ee)
        ok &= ke <= 1.01 * ee + floor
    return errs, ok


def rownorm_bwd_phase(dev):
    """K5's backward at both widths over 9,568 tokens a sample, at batch 1
    (the fine-tune's: one group of per-sample adaLN rows, the strips and
    the column-sum grid of one sample) and at the CFG-doubled batch 2:
    each site of a DiT block against autograd of the eager chain and the
    fp64 oracle, the same bits in a second run, timed beside its bound,
    its plain version and the eager chain's autograd backward; then one
    full-width block forward and backward under remat 'nothing' (as the
    fine-tune runs it), K5 counted (16 forward, 8 backward) and timed
    against the same block with the eager chains. Returns {width: {site:
    stats, "block": ...}}, the width "1.3b" or "14b" with "_b1" for batch
    1."""
    import torch

    from more4d_tpu_torch.kernels import rownorm
    from more4d_tpu_torch.nn.remat import Remat

    out = {}
    for key, (d, _) in ROWNORM_WIDTHS.items():
        for b in (1, 2):
            name = key if b == 2 else f"{key}_b1"
            sites = {}
            for site, (epi, x, kw, _) in rownorm_sites(dev, d, b=b).items():
                g = torch.Generator(dev).manual_seed(3)
                dy = torch.randn(x.shape, device=dev, generator=g).bfloat16()
                _, stats = rownorm.rownorm_cuda(epi, x, 1e-6, stats=True,
                                                **kw)
                got = rownorm.rownorm_bwd_cuda(epi, x, dy, stats, **kw)
                leaves = {"x": x.clone().requires_grad_(True)}
                taped = {}
                for k, v in kw.items():
                    if k == "film":
                        leaves["params"] = v[0].clone().requires_grad_()
                        leaves["gate"] = v[2].clone().requires_grad_()
                        taped[k] = (leaves["params"], v[1],
                                    leaves["gate"])
                    elif k in ("cos", "sin"):
                        taped[k] = v
                    else:
                        taped[k] = leaves[k] = v.clone().requires_grad_()
                names = list(leaves)
                chain = rownorm.rownorm_plain(epi, leaves["x"], 1e-6,
                                              **taped)
                eager = dict(zip(names, torch.autograd.grad(
                    chain, [leaves[n] for n in names], dy,
                    retain_graph=True)))
                wide = {k: (tuple(None if t is None else t.double()
                                  for t in v)
                            if k == "film" else v.double())
                        for k, v in kw.items()}
                oracle = rownorm.rownorm_backward_plain(
                    epi, x.double(), dy.double(),
                    rownorm.row_stats(epi, x.double(), 1e-6), **wide)
                errs, ok = rownorm_grad_errors(got, eager, oracle)
                if not ok:
                    raise AssertionError(
                        f"K5 backward {name} {site}: farther from the fp64 "
                        f"oracle than the eager chain: {errs}")
                again = rownorm.rownorm_bwd_cuda(epi, x, dy, stats, **kw)
                if not all(torch.equal(again[n], got[n]) for n in got):
                    raise AssertionError(f"K5 backward {name} {site}: two "
                                         f"runs differ")
                del oracle, wide, again
                ms = cuda_ms(lambda: rownorm.rownorm_bwd_cuda(
                    epi, x, dy, stats, **kw), 50, warmup=3)
                plain_ms = cuda_ms(lambda: rownorm.rownorm_backward_plain(
                    epi, x, dy, stats, **kw), 5)
                eager_ms = cuda_ms(lambda: torch.autograd.grad(
                    chain, [leaves[n] for n in names], dy,
                    retain_graph=True), 5)
                bms, by = bound_ms(rownorm_bwd_bytes(epi, x, kw), 0,
                                   BF16_FLOPS)
                sites[site] = dict(epilogue=epi, shape=list(x.shape),
                                   errors=errs, ms=ms, plain_ms=plain_ms,
                                   eager_bwd_ms=eager_ms, bound_ms=bms,
                                   bound_by=by, roofline=bms / ms)
                log(f"K5 backward {name} {site:12s} {epi:6s} "
                    f"{tuple(x.shape)}: vs fp64 (K5, eager) {errs} | kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, eager autograd "
                    f"{eager_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
                    f"{bms / ms:.3f} of it")
                del got, eager, chain, leaves, taped
            blk, args = rownorm_block(dev, key, b)
            blk.requires_grad_(True)
            remat = Remat("nothing", dev)

            def step():
                blk.zero_grad(set_to_none=True)
                xt = args[0].clone().requires_grad_(True)
                remat.run(blk, xt,
                          *args[1:]).float().square().mean().backward()
                return [xt.grad] + [p.grad for p in blk.parameters()]

            counters = _zero_counters()
            fast = step()
            launches = (counters["rownorm"].launches,
                        counters["rownorm_bwd"].launches)
            per_epi = dict(counters["rownorm_bwd"].epilogues)
            if launches != (16, 8) or per_epi != dict(film=2, affine=1,
                                                      rope=2, rms=3):
                raise AssertionError(f"K5 backward {name} block: launches "
                                     f"{launches} ({per_epi}), expected 16 "
                                     f"forward and 8 backward (2 film, 1 "
                                     f"affine, 2 rope, 3 rms)")
            block_ms = cuda_ms(step, 3)
            saved = rownorm._route
            rownorm._route = lambda *a: rownorm.PLAIN
            try:
                eager = step()
                eager_ms = cuda_ms(step, 3)
            finally:
                rownorm._route = saved
            num = sum((f.float() - e.float()).square().sum()
                      for f, e in zip(fast, eager))
            den = sum(e.float().square().sum() for e in eager)
            rel = (num.sqrt() / den.sqrt()).item()
            if not rel < 2e-2:
                raise AssertionError(f"K5 backward {name} block: "
                                     f"gradients |K5 - eager| / |eager| "
                                     f"{rel:.3e}")
            sites["block"] = dict(launches=launches, by_epilogue=per_epi,
                                  ms=block_ms, eager_ms=eager_ms,
                                  rel_err=rel)
            log(f"K5 backward {name} block forward + backward (remat "
                f"'nothing'): {launches[0]} forward and {launches[1]} "
                f"backward launches ({per_epi}); {block_ms:.3f} ms with K5, "
                f"{eager_ms:.3f} ms with the eager chains; gradients "
                f"|K5 - eager| / |eager| {rel:.2e}")
            out[name] = sites
            del blk, args, fast, eager
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- K6 phase

# the 14B's fp8 matrices widened to bf16: q, k, v, o, k_img and v_img; fc1;
# fc2; the FiLM projections; and widened to fp32, the time embedding's
# projection (K6 is elementwise: only the length, the start and the output
# type matter)
WIDEN_SHAPES = {"attn": ((5120, 5120), "bfloat16"),
                "fc1": ((13824, 5120), "bfloat16"),
                "fc2": ((5120, 13824), "bfloat16"),
                "film": ((10240, 768), "bfloat16"),
                "time_projection": ((30720, 5120), "float32")}
WIDEN_SCALE = 0.0123       # the scaled variant's scale
WIDEN_MIN_ROOFLINE = 0.75  # of the byte bound at fc1, unscaled

K6 = "widen_fp8"               # K6's launches in a count of launches
K6_WANT = "widen_fp8_wanted"   # the fp8 tensors of the modules called
K6_BY_PATH = {}                # {path: K6's launches}, as k6_check held them


class Fp8Tensors:
    """What K6 must launch: over the module calls since ``launches`` was
    last set to 0, the fp8 tensors on the card that each called module
    holds itself (``nn.layers.compute_param`` widens each once a call). A
    forward pre-hook on every module counts them, from the first
    ``_launch_counters`` of the process on."""

    launches = 0
    hook = None

    @classmethod
    def install(cls):
        import torch

        if cls.hook is not None:
            return
        fp8 = torch.float8_e4m3fn

        def count(module, args):
            cls.launches += sum(
                p is not None and p.dtype == fp8 and p.device.type == "cuda"
                for p in module._parameters.values())

        cls.hook = torch.nn.modules.module.register_module_forward_pre_hook(
            count)


def _k6_counts():
    """K6's launches and what it must launch, as counted since the last
    ``_zero_counters``."""
    from more4d_tpu_torch.kernels.widen import widen_fp8_cuda

    return {K6: widen_fp8_cuda.launches, K6_WANT: Fp8Tensors.launches}


def k6_check(path, launches, fp8):
    """K6's launches in ``launches`` held to the fp8 tensors of the modules
    called (both counted from zero together): one a tensor a call, so no
    fp8 weight on the card widens by anything but K6, and none twice; with
    ``fp8`` (the path's DiTs hold fp8 weights) some, without none. Kept
    under ``path`` for the kernels line."""
    k6, want = launches[K6], launches[K6_WANT]
    if k6 != want or (k6 > 0) != fp8:
        raise AssertionError(
            f"{path}: K6 {k6} launches, expected {want} (one for each fp8 "
            f"tensor of each module called), and {'some' if fp8 else 'none'}")
    K6_BY_PATH[path] = k6


def widen_codes(dev, shape, seed):
    """fp8 (e4m3) codes of ``shape`` on the card: the 256 codes in order,
    then random ones from ``seed``."""
    import torch

    n = int(np.prod(shape))
    g = torch.Generator(dev).manual_seed(seed)
    c = torch.randint(0, 256, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    k = min(n, 256)
    c[:k] = torch.arange(k, device=dev, dtype=torch.int32)
    return c.to(torch.uint8).view(torch.float8_e4m3fn).view(shape)


def widen_agreement(got, want):
    """K6's output against the plain cast's: {'finite_bits': the same bits
    wherever the plain one is finite, 'nan': NaN where it is NaN,
    'nan_bits': the NaNs' bits the same too}."""
    import torch

    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    nan = torch.isnan(want)
    gi, wi = got.view(as_int[got.dtype]), want.view(as_int[want.dtype])
    return dict(finite_bits=bool(torch.equal(gi[~nan], wi[~nan])),
                nan=bool(torch.equal(torch.isnan(got), nan)),
                nan_bits=bool(torch.equal(gi[nan], wi[nan])))


def fp8_tensors_a_forward(cfg):
    """The fp8 tensors one whole forward of a DiT of ``cfg`` widens, each
    once (K6's launches), as ``_should_quantize`` picks them:
    (``--fp8_weights``: over the whole model on the JAX parameter paths,
    block biases and gates and the time embedding's included;
    ``--offload_blocks``: each block's matrices over its layers, the
    resident part in bf16)."""
    import torch

    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.utils.quantize import _should_quantize, jax_param

    with torch.device("meta"):
        model = WanDiT(cfg)
    resident = sum(_should_quantize(*jax_param(n, p))
                   for n, p in model.named_parameters())
    per_block = sum(_should_quantize(k, v.dim())
                    for k, v in model.blocks[0].state_dict().items())
    return resident, per_block * cfg.num_layers


def widen_forward(label, dit, dev, fp8, want=None, grad=False):
    """One forward of ``dit`` (a WanDiT or a StreamedDiT) on a small input,
    counted: K6 held to the fp8 tensors of the modules called
    (``k6_check``) and, where given, to ``want``; K1 to 3 a layer. With
    ``grad``, under a gradient and with a backward (every block
    rematerialised: K1 6 a layer). Returns {k6_a_forward, k1_a_forward}."""
    import torch

    cfg = dit.cfg
    x, t, ctx, y, clip, mpm = small_dit_inputs(cfg, dev, seed=3)

    def forward():
        with torch.set_grad_enabled(grad):
            out = dit(x, t, ctx, y=y, clip_fea=clip, mpm_features=mpm)
            if grad:
                out.float().square().mean().backward()
        torch.cuda.synchronize()

    _, launches = _run_counted(forward)
    k1 = launches["flash_attention"]
    want_k1 = (6 if grad else 3) * cfg.num_layers
    log(f"K6 {label}: {launches[K6]} launches a forward (expected {want}; "
        f"the fp8 tensors of the modules called {launches[K6_WANT]}), K1 "
        f"{k1}")
    if k1 != want_k1 or want not in (None, launches[K6]):
        raise AssertionError(f"K6 {label}: a forward launched K6 "
                             f"{launches[K6]} and K1 {k1} times, expected "
                             f"{want} and {want_k1}")
    k6_check(f"widen_{label}", launches, fp8)
    return dict(k6_a_forward=launches[K6], k1_a_forward=k1)


def widen_phase(dev, smi):
    """K6 at the 14B's fp8 matrix shapes, to bf16 and to fp32 (the time
    embedding's): unscaled and scaled, bit for bit against the plain cast
    (the 256 codes and random ones, NaNs included), timed beside its byte
    bound (1 byte read, 2 or 4 written an element) and the plain cast; at
    least WIDEN_MIN_ROOFLINE of the bound at fc1. Then its launches a
    forward on each path, one a fp8 tensor (``fp8_tensors_a_forward``)
    beside K1's 3 a layer: the 14B as ``--fp8_weights`` holds it and as
    ``--offload_blocks`` streams it; none on the 1.3B's bf16 weights nor on
    the fine-tune's fp32 ones (forward and backward). The 14B steps
    themselves are the benchmark's. Returns {case: stats, 'paths': ...}."""
    import gc

    import torch

    from more4d_tpu_torch.config import dit_1_3b
    from more4d_tpu_torch.kernels.widen import widen_fp8_cuda, widen_fp8_plain
    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.parallel import StreamedDiT, make_host_blocks

    out = {}
    for seed, (site, (shape, name)) in enumerate(WIDEN_SHAPES.items()):
        dtype = getattr(torch, name)
        p = widen_codes(dev, shape, seed)
        n = p.numel()
        for scaled in (False, True):
            scale = (torch.tensor(WIDEN_SCALE, device=dev) if scaled
                     else None)
            agree = widen_agreement(widen_fp8_cuda(p, dtype, scale),
                                    widen_fp8_plain(p, dtype, scale))
            if not all(agree.values()):
                raise AssertionError(f"K6 {site} scaled={scaled}: differs "
                                     f"from the plain cast: {agree}")
            ms = cuda_ms(lambda: widen_fp8_cuda(p, dtype, scale), 50,
                         warmup=3)
            plain_ms = cuda_ms(lambda: widen_fp8_plain(p, dtype, scale), 20,
                               warmup=2)
            out_bytes = torch.empty((), dtype=dtype).element_size()
            bms, by = bound_ms((1 + out_bytes) * n, 0, BF16_FLOPS)
            key = site + ("_scaled" if scaled else "")
            out[key] = dict(shape=list(shape), out=name, **agree, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            roofline=bms / ms, plain_roofline=bms / plain_ms)
            log(f"K6 {key:17s} {tuple(shape)} to {name}: kernel {ms:.4f} "
                f"ms, plain cast {plain_ms:.4f} ms, bound {bms:.4f} ms "
                f"({by}): {bms / ms:.3f} of it (plain {bms / plain_ms:.3f}); "
                f"{agree}; on {smi}")
        del p
    if out["fc1"]["roofline"] < WIDEN_MIN_ROOFLINE:
        raise AssertionError(f"K6 at fc1: {out['fc1']['roofline']:.3f} of "
                             f"its byte bound, under {WIDEN_MIN_ROOFLINE}")

    paths = {}
    cfg14 = dit_14b_configs()["motion"]
    want_fp8, want_streamed = fp8_tensors_a_forward(cfg14)
    model = build_fp8_dit_14b_blockwise(cfg14, dev, seed=14)
    paths["fp8"] = widen_forward("fp8", model, dev, True, want_fp8)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    resident, host = make_host_blocks(cfg14, cfg14.num_layers, "fp8", dev,
                                      seed=1000)
    gen = torch.Generator(dev).manual_seed(14)
    resident.init_weights(gen)
    _draw_zero_init(resident, gen)
    sd = StreamedDiT(resident, host, dev)
    paths["streamed"] = widen_forward("streamed", sd, dev, True,
                                      want_streamed)
    del sd, resident, host
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned()

    bf16 = dit_1_3b(motion_guidance=True, in_dim=64, model_type="i2v",
                    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    with torch.device(dev):
        dit = WanDiT(bf16).to(torch.bfloat16).eval()
    paths["1.3b"] = widen_forward("1.3b", dit, dev, False, 0)
    del dit
    paths["train"] = widen_forward("train", build_straag_dit(dev), dev,
                                   False, 0, grad=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["paths"] = paths
    return out


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
    k5 = _zero_counters()["rownorm"]
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
                "gs_splat": splat_cuda.launches, "rownorm": k5.launches}
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
    k6 = _k6_counts()
    log(f"main path launches: {launches}, K6 {k6}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    k5_check("run_two_stage", launches)
    k6_check("run_two_stage", k6, fp8=False)

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
    check_dit_against_plain(m.control_pipeline.dit, dev)
    stats = dict(timings, run_two_stage_s=t1 - t0, sweep_s=t2 - t1,
                 peak_gib=peak, dit_step_s=step_ms / 1e3)
    profile_phase({"dit_step": step,
                   "stage1": lambda: stage1_generate(m, image, PROMPT)})
    return m, encoders, launches, stats


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


def tower_makers():
    """{tower: dtype -> its module}: umT5-xxl, CLIP ViT-H/14, OmniMAE ViT-B
    and UniDepth-V2 at full width."""
    import dataclasses

    from more4d_tpu_torch.config import CLIPVisionConfig, T5Config
    from more4d_tpu_torch.models import ClipVisionTower, UniDepthV2, \
        WanT5Encoder
    from more4d_tpu_torch.models.omnimae import omnimae_vit

    t5_cfg, clip_cfg = T5Config(), CLIPVisionConfig()
    return {
        "t5": lambda dt: WanT5Encoder(dataclasses.replace(t5_cfg, dtype=dt)),
        "clip": lambda dt: ClipVisionTower(dataclasses.replace(clip_cfg,
                                                               dtype=dt)),
        "omnimae": lambda dt: omnimae_vit("vit_base"),
        "unidepth": lambda dt: UniDepthV2(),
    }


def build_towers(dev, seed=0):
    """The four towers with random weights from ``seed``, allocated on the
    card in bf16 (built on the meta device, no fp32 copy)."""
    import torch

    from more4d_tpu_torch.nn.layers import materialize

    gen = torch.Generator(dev).manual_seed(seed)
    t0 = time.perf_counter()
    towers = {name: materialize(lambda: make(torch.bfloat16), dev,
                                torch.bfloat16, gen).eval()
              for name, make in tower_makers().items()}
    torch.cuda.synchronize()
    log(f"towers: built in {time.perf_counter() - t0:.1f} s on the card in "
        f"bf16: " + ", ".join(
            f"{n} {sum(p.numel() for p in t.parameters()) / 1e9:.3f}e9 "
            f"params" for n, t in towers.items()))
    return towers


def towers_phase(dev):
    """The four towers at full width with random weights from a seed,
    allocated on the card in bf16 as the JAX CLI casts its towers: umT5-xxl
    and CLIP ViT-H/14 compute in bf16; OmniMAE ViT-B and UniDepth-V2 in
    fp32 from their bf16 weights, as their JAX modules' dtype does. Each is
    timed on its main-path input (umT5 also on 2 full 512-token prompts,
    CLIP also on one 224 image), with its weights and its peak memory, and
    held to the same weights in fp32 computed with TF32 off: relative
    2-norm error under TOWER_REL_TOL."""
    import torch

    from more4d_tpu_torch.config import T5Config
    from more4d_tpu_torch.models import UniDepthProvider
    from more4d_tpu_torch.models.clip import encode_image
    from more4d_tpu_torch.models.omnimae import extract_mpm_features

    t5_cfg = T5Config()
    makes = tower_makers()
    towers = build_towers(dev)
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
    conditioning. Each step is timed (device synchronised) and its K1 and
    K5 launches counted: a replay step must launch none, a calc step 90 K1
    and 240 K5 (3 and 8 a block). If no step replays at 0.10, the loop runs again at twice the
    largest per-step polynomial value, where one must. The loop that
    replayed runs once more with ``offload_residual`` (the residual parked
    in pinned host memory between steps) and must give the same bits."""
    import torch

    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.infer.two_stage import grey_clip_image
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.rownorm import rownorm_cuda
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

    def run(thresh, offload=False):
        pipe = WanControlPipeline(
            base.dit, base.vae, PipelineConfig(num_inference_steps=12,
                                               num_frames=FRAMES, height=H,
                                               width=W), dev,
            teacache=TeaCacheConfig(coeffs, thresh, 2,
                                    offload_residual=offload))
        steps, step = [], pipe._step

        def timed(*a, **k):
            torch.cuda.synchronize()
            n0, t0 = flash_attention_cuda.launches, time.perf_counter()
            k0 = rownorm_cuda.launches
            out = step(*a, **k)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3,
                          flash_attention_cuda.launches - n0,
                          rownorm_cuda.launches - k0))
            return out

        pipe._step = timed
        out = pipe.denoise(latents, ctx, neg, y=y, clip_fea=clip,
                           mpm_features=mpm)
        log_ = pipe.teacache_state.log
        kinds = {True: [], False: []}
        for (ms, k1, k5), (_, _, calc) in zip(steps, log_):
            kinds[calc].append(ms)
            want = (3 * cfg.num_layers, K5_PER_BLOCK * cfg.num_layers) \
                if calc else (0, 0)
            if (k1, k5) != want:
                raise AssertionError(f"TeaCache at {thresh}: a "
                                     f"{'calc' if calc else 'replay'} step "
                                     f"launched {k1} K1 and {k5} K5, "
                                     f"expected {want}")
        if not torch.isfinite(out).all():
            raise AssertionError("TeaCache denoise gave non-finite latents")
        residual = pipe.teacache_state.residual
        if offload and not (residual.device.type == "cpu"
                            and residual.is_pinned()):
            raise AssertionError("offload_residual: the residual is not in "
                                 "pinned host memory")
        res = dict(
            threshold=thresh, offload_residual=offload,
            sequence="".join("C" if c else "r" for _, _, c in log_),
            rel=[r for r, _, _ in log_], poly=[p for _, p, _ in log_],
            k1_per_step=[k for _, k, _ in steps],
            k5_per_step=[k for _, _, k in steps],
            calc_ms=float(np.mean(kinds[True])),
            replay_ms=float(np.mean(kinds[False])) if kinds[False] else None,
            step_ms=[ms for ms, _, _ in steps])
        replay = ("none" if res["replay_ms"] is None
                  else f"{res['replay_ms']:.2f} ms")
        log(f"teacache at {thresh:.4g}{', residual offloaded' if offload else ''}"
            f": sequence {res['sequence']} (C calc, r replay), K1 a step "
            f"{res['k1_per_step']}, K5 a step {res['k5_per_step']}, calc "
            f"{res['calc_ms']:.1f} ms a step, replay {replay} a step; rel "
            f"{[round(r, 5) for r in res['rel'][1:]]}, poly "
            f"{[round(p, 5) for p in res['poly'][1:]]}")
        return res, out

    first, out = run(0.10)
    runs = [first]
    if "r" not in first["sequence"]:
        thresh = 2.0 * max(first["poly"][2:])
        second, out = run(thresh)
        runs.append(second)
        if "r" not in second["sequence"]:
            raise AssertionError(f"no TeaCache replay at {thresh}")
    offloaded, got = run(runs[-1]["threshold"], offload=True)
    same = (offloaded["sequence"] == runs[-1]["sequence"]
            and torch.equal(got, out))
    log(f"teacache: the residual in pinned host memory gives the resident "
        f"residual's latents bit for bit: {same}")
    if not same:
        raise AssertionError(
            f"offload_residual changed the loop: sequence "
            f"{offloaded['sequence']} against {runs[-1]['sequence']}, max "
            f"|diff| {(got - out).abs().max().item():.3e}")
    return runs + [offloaded]


def dit_step_inputs(cfg, dev):
    """A CFG-doubled step's inputs at the operating point (batch 2, 9,568
    tokens) from seed 1: (x, t, text, {y, clip_fea, mpm_features})."""
    import torch

    g = torch.Generator(dev).manual_seed(1)
    lat = (2, (FRAMES - 1) // 4 + 1, H // 8, W // 8)
    x = torch.randn(*lat, 16, device=dev, generator=g)
    y = torch.randn(*lat, cfg.in_dim - 16, device=dev, generator=g)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, device=dev, generator=g)
    clip = torch.randn(2, cfg.clip_tokens, cfg.clip_dim, device=dev,
                       generator=g)
    mpm = torch.randn(2, 196, cfg.motion_feature_dim, device=dev,
                      generator=g)
    return x, torch.full((2,), 900.0, device=dev), ctx, dict(
        y=y, clip_fea=clip, mpm_features=mpm)


def dit_step(m, dev):
    """One CFG-doubled stage-1 DiT forward at the operating point (batch
    2, 9,568 tokens), as a closure."""
    import torch

    pipe = m.control_pipeline
    x, t, ctx, kw = dit_step_inputs(pipe.dit.cfg, dev)

    def step():
        with torch.no_grad():
            return pipe.dit(x, t, ctx, rope_tables=pipe.rope_tables, **kw)

    return step


HOST_COPIES = "host-to-card copies"


def _kernel_kind(name):
    """The kind of a device kernel, by its name: the port's kernels
    (PORT_KERNELS), the foreach kernels of AdamW and the EMA, cuDNN convolutions (with their
    layout transposes), cuBLAS matmuls, the copies from host memory (a
    streamed DiT's run on their own stream, beside the compute), PyTorch's
    dtype casts and other copies, reductions, other elementwise kernels."""
    for sub, kind in PORT_KERNELS:
        if sub in name:
            return kind
    low = name.lower()
    if "memcpy htod" in low:
        return HOST_COPIES
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
    1 - (kernel time, copies from the host left out) / (unprofiled
    wall)."""
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
        kinds = {}
        for k, (ms, _) in per_kernel.items():
            kinds[_kernel_kind(k)] = kinds.get(_kernel_kind(k), 0.0) + ms
        # the compute's busy time: copies from the host overlap it on a
        # stream of their own where the blocks stream
        busy = sum(ms for k, ms in kinds.items() if k != HOST_COPIES)
        log(f"profile {name}: wall {wall_ms:.1f} ms, kernels {busy:.1f} ms "
            f"besides {kinds.get(HOST_COPIES, 0.0):.1f} ms of copies from "
            f"the host, device idle {1 - busy / wall_ms:.3f} of the wall")
        for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
            log(f"  {kind:40s} {ms:10.2f} ms  {ms / wall_ms:6.3f} of wall")
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:12]
        for k, (ms, n) in top:
            log(f"    {ms:9.2f} ms {n:6d} x  {k[:110]}")
        report[name] = dict(wall_ms=wall_ms, kernel_ms=busy,
                            idle_share=1 - busy / wall_ms, by_kind=kinds)
    log("profile: " + json.dumps(report))
    return report


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


def check_dit_against_plain(dit, dev, backbone=None, label="1.3B"):
    """A stage-1 DiT with K1 against the same DiT with the plain attention,
    on a small input (5 frames at 64x64): relative error of the block
    stack's bf16 output below 5e-2. ``backbone``: the block walk (the
    DiT's own, or a ``StreamedDiT``'s over ``dit``, its resident part)."""
    import importlib

    import torch

    from more4d_tpu_torch.kernels import flash_attention as fa

    # the module itself: the package re-exports a function of the same name
    attn_mod = importlib.import_module("more4d_tpu_torch.nn.attention")
    backbone = backbone or dit.backbone
    x, t, ctx, y, clip, mpm = small_dit_inputs(dit.cfg, dev, 2)

    def run():
        # the block stack's output tokens: the random model's output head
        # is zero-initialised, so its velocity would be zero either way
        with torch.no_grad():
            it = dit.embed(x, t, ctx, y=y, clip_fea=clip, mpm_features=mpm)
            return backbone(it).float()

    before = fa.flash_attention_cuda.launches
    got = run()
    kernel_calls = fa.flash_attention_cuda.launches - before

    def plain_attention(q, k, v, kv_lens=None, name=""):
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
    log(f"{label} DiT blocks with K1 ({kernel_calls} launches) vs with the "
        f"plain attention ({stray} launches), 1x2x8x8 latents: relative "
        f"error {rel:.3e} (tol 5e-2)")
    if kernel_calls == 0 or stray != 0:
        raise AssertionError("the DiT comparison did not switch between K1 "
                             "and the plain attention")
    if not (torch.isfinite(got).all() and rel < 5e-2):
        raise AssertionError(f"{label} DiT with K1 disagrees with the plain "
                             f"attention: relative error {rel:.3e}")
    return rel


# ----------------------------------------------------------------- the CLI

CLI_STEPS = 3
CLI_TRAJECTORIES = "static,3"
LORA_WEIGHT = 0.55
# the CLI again on the same checkpoints, in each memory mode
CLI_MEMORY_MODES = {
    "fp8": ["--fp8_weights", "--teacache_offload"],
    "offload": ["--offload_blocks", "--teacache_offload", "--stage2_batch",
                "2", "--stage2_denoise_group", "1",
                "--no-stage2_shared_noise"],
}


def write_cli_checkpoints(root, dev, seed=0):
    """Synthetic checkpoints in the released layouts, written by the port's
    writer, random weights from ``seed`` at the 1.3B operating point's
    widths: the Control DiT as a released 3D checkpoint (48 input channels,
    no 4D groups) in bf16, in two ``diffusion_pytorch_model-0000k-of-00002
    .safetensors`` shards; the InP DiT as one bf16 ``.safetensors``; the
    Wan VAE as a ``.pth`` under ``model.``; the decoder and encoder
    adaptors as ``.bin`` files; a rank-4 kohya ViSM LoRA with a non-zero up factor; CLIP
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
    enc = encoder_adaptor(dev, seed + 2)
    for name, obj in (
            ("vae.pth", cpu(vae, prefix="model.")),
            ("decoder_adaptor.bin", cpu(dec)),
            ("encoder_adaptor.bin", cpu(enc)),
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
    del vae, towers, dec, enc
    torch.cuda.empty_cache()
    return {k: (p, size(p)) for k, p in out.items()}


def cli_phase(dev, smi, ck, root):
    """The port's CLI (``more4d_tpu_torch.scripts.infer``) on released-
    layout checkpoints at the 1.3B width (``ck``, ``write_cli_checkpoints``'
    files under ``root``): the CLI's own ``load_models`` and ``run_sample`` with
    ``--model_size 1.3b --allow_dummy_text --sampler flow_dpm++
    --num_inference_steps 3 --trajectories static,3 --vism_lora ...
    --lora_weight 0.55`` (TeaCache at its default; no umT5 checkpoint or
    tokenizer exists, the towers phase covers umT5), and stage 1 again with
    ``flow_unipc`` on the weights already loaded; then the whole CLI again
    in each of CLI_MEMORY_MODES (fp8 DiT weights; blocks streamed from
    pinned host memory with stage 2's options), TeaCache's residual in
    pinned host memory in both. Fails unless the outputs are finite and of
    the CLI's shapes, the merged InP weights are the loaded ones plus 0.55
    (alpha / r) up @ down to within bf16 rounding, the fresh FiLM is
    exactly zero, and K1 and K4 launched 90 a calc step and one a
    trajectory."""
    import dataclasses

    import torch

    from more4d_tpu_torch.convert.lora_torch import load_vism_lora
    from more4d_tpu_torch.diffusion import get_scheduler
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda
    from more4d_tpu_torch.scripts import infer
    from more4d_tpu_torch.utils.safetensors_io import load_file

    stats = {}
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
    stats["load_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
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
    runs, peaks = {}, {}
    pre_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for sampler in ("flow_dpm++", "flow_unipc"):
        if sampler == "flow_unipc":
            # stage 1 and the render again, on the loaded weights
            pipe = models.control_pipeline
            pipe.config = dataclasses.replace(pipe.config,
                                              scheduler=sampler)
            pipe.scheduler = get_scheduler(sampler, CLI_STEPS,
                                           args.shift)
            args.sampler, args.run_stage2_complete = sampler, False
        k5 = _zero_counters()["rownorm"]
        splat_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with peaks_by_stage(peaks):
            out = infer.run_sample(models, image01, PROMPT, args,
                                   torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": flash_attention_cuda.launches,
                    "gs_splat": splat_cuda.launches, "rownorm": k5.launches}
        k6_check(f"cli_{sampler}", _k6_counts(), fp8=False)
        check_cli_outputs(out, n_traj, args.run_stage2_complete)
        pipes = [models.control_pipeline] + (
            [models.inpaint_pipeline] if args.run_stage2_complete else [])
        calc = [c for p in pipes for _, _, c in p.teacache_state.log]
        if not all(calc):
            # 3 steps are all TeaCache warm-up (5 warm steps)
            raise AssertionError(f"cli {sampler}: a step replayed")
        steps = CLI_STEPS * (1 + (n_traj if args.run_stage2_complete
                                  else 0))
        layers = models.control_pipeline.dit.cfg.num_layers
        want = {"flash_attention": 3 * layers * steps, "gs_splat": n_traj,
                "rownorm": K5_PER_BLOCK * layers * steps}
        log(f"cli {sampler}: run_sample {wall:.2f} s (stage 1 "
            f"{out['timings']['stage1_s']:.2f} s, render "
            f"{out['timings']['render_s']:.2f} s, stage 2 "
            f"{out['timings']['stage2_s']:.2f} s); launches "
            f"{launches}, expected {want} (K1 90 a CFG-doubled calc "
            f"step, {steps} steps; K4 one a trajectory; K5 240 a step); "
            f"K5 by epilogue {dict(k5.epilogues)}; TeaCache "
            f"calc steps of the last loops {calc}; on {smi}")
        if launches != want:
            raise AssertionError(f"cli {sampler}: launches {launches}, "
                                 f"expected {want}")
        k5_check(f"cli_{sampler}", launches)
        runs[sampler] = dict(out["timings"], run_sample_s=wall,
                             launches=launches)
    stats["peak_gib"] = max([pre_peak, torch.cuda.max_memory_allocated()
                             / 2 ** 30] + list(peaks.values()))
    stats.update(peaks)
    log(f"cli: peak memory {stats['peak_gib']:.2f} GiB (two 1.3B DiTs, "
        f"the VAE, CLIP, OmniMAE and UniDepth resident; "
        f"{stats['load_peak_gib']:.2f} GiB after load_models, "
        f"{pre_peak:.2f} with the LoRA check; by stage "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f") on {smi}")
    # pipe and pipes (the UniPC run's) hold the stage-1 DiT: the memory
    # modes' peaks would count it
    del models, out, pipe, pipes
    torch.cuda.empty_cache()
    for mode, flags in CLI_MEMORY_MODES.items():
        runs[mode] = cli_memory_mode(dev, smi, argv + flags, image01,
                                     n_traj, mode)
    stats["runs"] = runs
    torch.cuda.empty_cache()
    return stats


def cli_memory_mode(dev, smi, argv, image01, n_traj, mode):
    """The CLI's ``load_models`` and ``run_sample`` (DPM++) with a memory
    mode's flags: the DiTs' matrices in fp8 on the card, or their blocks
    in pinned host memory behind a ``StreamedDiT`` each; the same launches,
    outputs and all-calc TeaCache as the bf16 run."""
    import torch

    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda
    from more4d_tpu_torch.scripts import infer

    args = infer.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    load_s = {}
    t0 = time.perf_counter()
    models = infer.load_models(args, dev, timings=load_s)
    torch.cuda.synchronize()
    load_wall = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pipes = [models.control_pipeline, models.inpaint_pipeline]
    if args.offload_blocks:
        host = [hb for p in pipes for hb in p.streamed_dit.host_blocks]
        pinned = sum(hb.flat.numel() for hb in host) / 2 ** 30
        if not all(hb.flat.is_pinned() for hb in host) or any(
                len(p.dit.blocks) for p in pipes):
            raise AssertionError("cli offload: blocks not all in pinned "
                                 "host memory, or some left on the card")
        held = f"{len(host)} blocks, {pinned:.3f} GiB in pinned host memory"
    else:
        dtypes = {p.dit.blocks[0].self_attn.q.weight.dtype for p in pipes}
        if dtypes != {torch.float8_e4m3fn}:
            raise AssertionError(f"cli fp8: DiT weights in {dtypes}")
        held = "DiT matrices in float8_e4m3fn on the card"
    if not all(p.teacache.offload_residual for p in pipes):
        raise AssertionError(f"cli {mode}: TeaCache residual not offloaded")
    k5 = _zero_counters()["rownorm"]
    splat_cuda.launches = 0
    t0 = time.perf_counter()
    peaks = {}
    with peaks_by_stage(peaks):
        out = infer.run_sample(models, image01, PROMPT, args,
                               torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention_cuda.launches,
                "gs_splat": splat_cuda.launches, "rownorm": k5.launches}
    k6_check(f"cli_{mode}", _k6_counts(), fp8=True)
    check_cli_outputs(out, n_traj, True)
    if not all(c for p in pipes for _, _, c in p.teacache_state.log):
        raise AssertionError(f"cli {mode}: a step replayed")
    forwards = pipes[0].dit.cfg.num_layers * CLI_STEPS * (1 + n_traj)
    want = {"flash_attention": 3 * forwards, "gs_splat": n_traj,
            "rownorm": K5_PER_BLOCK * forwards}
    peak = max([load_peak, torch.cuda.max_memory_allocated() / 2 ** 30]
               + list(peaks.values()))
    log(f"cli {mode} ({' '.join(argv[argv.index('--output_dir') + 2:])}): "
        f"load_models {load_wall:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in load_s.items())
        + f"); {held}; run_sample {wall:.2f} s (stage 1 "
        f"{out['timings']['stage1_s']:.2f} s, render "
        f"{out['timings']['render_s']:.2f} s, stage 2 "
        f"{out['timings']['stage2_s']:.2f} s); launches {launches}, expected "
        f"{want}; peak memory {peak:.2f} GiB ({load_peak:.2f} after "
        f"load_models; by stage "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()) + f"); on {smi}")
    if launches != want:
        raise AssertionError(f"cli {mode}: launches {launches}, expected "
                             f"{want}")
    k5_check(f"cli_{mode}", launches)
    del models, out
    torch.cuda.empty_cache()
    return dict(load_s=load_wall, load_by_checkpoint_s=load_s,
                run_sample_s=wall, peak_gib=peak, load_peak_gib=load_peak,
                launches=launches, **peaks)


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


# ------------------------------------------------------------------- 14B

STEPS_14B = 3       # timed CFG-doubled 14B steps (after one warm-up)


@contextlib.contextmanager
def peaks_by_stage(out):
    """Within the block, ``run_two_stage``'s three stages record their
    peak device memory in GiB into ``out`` (each stage's peak from its
    start)."""
    import torch

    from more4d_tpu_torch.infer import two_stage

    names = {"stage1_generate": "stage1", "render_trajectories": "render",
             "stage2_inpaint_batch": "stage2"}
    saved = {n: getattr(two_stage, n) for n in names}

    def wrap(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                key = names[name] + "_peak_gib"
                out[key] = max(out.get(key, 0.0),
                               torch.cuda.max_memory_allocated() / 2 ** 30)
        return run

    for n, fn in saved.items():
        setattr(two_stage, n, wrap(n, fn))
    try:
        yield out
    finally:
        for n, fn in saved.items():
            setattr(two_stage, n, fn)


def pinned_bandwidth(dev):
    """Host -> card GB/s of one 1 GiB copy from pinned memory, warm, timed
    by CUDA events."""
    import torch

    src = torch.empty(2 ** 30, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(2 ** 30, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), 1)
    del src, dst
    return 2 ** 30 / ms / 1e6


def dit_14b_configs():
    """{'motion': the 14B 4D-STraG DiT (motion guidance, in_dim 64), 'inp':
    the 14B InP DiT (in_dim 36)}, both computing in bf16."""
    import torch

    from more4d_tpu_torch.config import dit_14b

    bf16 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    return {"motion": dit_14b(motion_guidance=True, in_dim=64,
                              model_type="i2v", **bf16),
            "inp": dit_14b(motion_guidance=False, in_dim=36,
                           model_type="i2v", **bf16)}


def build_dits_14b(dev, stats):
    """The two 14B DiTs as ``StreamedDiT``s (the CLI's ``--offload_blocks``):
    seeded random blocks made straight into pinned host memory
    (``make_host_blocks``: fp8 matrices, bf16 vectors), the resident part
    (embeddings, head, norms) drawn from a seed in bf16 on the card.
    Returns ({'motion', 'inp'}: StreamedDiT, the generator)."""
    import torch

    from more4d_tpu_torch.parallel import StreamedDiT, make_host_blocks

    gen = torch.Generator(dev).manual_seed(14)
    dits = {}
    for seed, (name, cfg) in enumerate(dit_14b_configs().items()):
        t0 = time.perf_counter()
        resident, host = make_host_blocks(cfg, cfg.num_layers, "fp8", dev,
                                          seed=1000 * (seed + 1))
        resident.init_weights(gen)
        with torch.no_grad():
            # the output head is zero at init: draw it so velocities move
            resident.head.head.weight.normal_(0.0, 0.02, generator=gen)
        dits[name] = StreamedDiT(resident, host, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        gib = sum(hb.flat.numel() for hb in host) / 2 ** 30
        stats[f"{name}_build_s"], stats[f"{name}_pinned_gib"] = secs, gib
        log(f"14b: {name} DiT built in {secs:.1f} s: {len(host)} blocks, "
            f"{gib:.3f} GiB in pinned host memory (fp8 matrices), resident "
            f"part {sum(p.numel() for p in resident.parameters()) / 1e9:.3f}"
            f"e9 params in bf16 on the card")
    return dits, gen


def build_fp8_dits_14b(dev, gen, stats):
    """The two 14B DiTs as the CLI's ``--fp8_weights`` holds them: each
    built on the card in bf16 (``materialize``: random weights from
    ``gen``, the output head drawn) and quantized in place, unscaled
    (``quantize_params_fp8``). Returns {'motion', 'inp'}: WanDiT."""
    import torch

    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.nn.layers import materialize
    from more4d_tpu_torch.utils.quantize import FP8, quantize_params_fp8

    models = {}
    for name, cfg in dit_14b_configs().items():
        t0 = time.perf_counter()
        model = materialize(lambda: WanDiT(cfg), dev, torch.bfloat16, gen)
        with torch.no_grad():
            model.head.head.weight.normal_(0.0, 0.02, generator=gen)
        models[name] = quantize_params_fp8(model, scaled=False).eval()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = {k: sum(p.numel() for p in model.parameters()
                    if (p.dtype == FP8) == (k == "fp8"))
             for k in ("fp8", "bf16")}
        stats[f"{name}_fp8_build_s"] = secs
        log(f"14b fp8_weights: {name} DiT built and quantized in {secs:.1f} "
            f"s: {n['fp8'] / 1e9:.3f}e9 params in fp8, {n['bf16'] / 1e9:.3f}"
            f"e9 in bf16")
    stats["fp8_dits_gib"] = sum(
        p.numel() * p.element_size() for m in models.values()
        for p in m.parameters()) / 2 ** 30
    return models


def teacache_replay_14b(dev, sd, vae, lat, ctx, neg, kw):
    """TeaCache replaying at 14B, through ``sd`` (a ``StreamedDiT`` whose
    model also holds its blocks resident in fp8): 4 steps, the last
    cond-only (``cfg_skip_ratio`` 0.25), a constant polynomial of 1 against
    a threshold of 1.5 after one warm step, so steps 0 and 2 compute and 1
    and 3 replay, the last from the cond half of the residual. The
    pipeline's loop over the streamed walk and over the resident blocks,
    each with its residual on the card and in pinned host memory, must
    give the same latents bit for bit, each with K1 at 120 a calc step and
    none a replay step. Returns {loop: seconds, launches}."""
    import torch

    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.pipelines import TeaCacheConfig
    from more4d_tpu_torch.pipelines.base import BasePipeline

    pcfg = PipelineConfig(num_inference_steps=4, num_frames=FRAMES, height=H,
                          width=W, cfg_skip_ratio=0.25)
    want_calc = [True, False, True, False]
    want_k1 = 2 * 3 * sd.cfg.num_layers
    outs, stats = {}, {}
    for loop in ("streamed", "streamed, residual offloaded", "resident",
                 "resident, residual offloaded"):
        offloaded = loop.endswith("offloaded")
        tc = TeaCacheConfig((0.0, 0.0, 0.0, 0.0, 1.0), 1.5, 1,
                            offload_residual=offloaded)
        pipe = BasePipeline(sd.model, vae, pcfg, dev, teacache=tc,
                            streamed_dit=sd if loop.startswith("streamed")
                            else None)
        sd.rope_tables = pipe.rope_tables
        torch.cuda.synchronize()
        flash_attention_cuda.launches, t0 = 0, time.perf_counter()
        outs[loop] = pipe.denoise(lat, ctx, neg, **kw)
        torch.cuda.synchronize()
        calc = [c for _, _, c in pipe.teacache_state.log]
        stats[loop] = dict(s=time.perf_counter() - t0,
                           k1=flash_attention_cuda.launches, calc=calc)
        if offloaded and not pipe.teacache_state.residual.is_pinned():
            raise AssertionError(f"14b TeaCache, {loop} loop: the residual "
                                 f"is not in pinned host memory")
        if calc != want_calc or stats[loop]["k1"] != want_k1:
            raise AssertionError(f"14b TeaCache, {loop} loop: calc {calc}, "
                                 f"K1 {stats[loop]['k1']}; expected "
                                 f"{want_calc}, {want_k1}")
    same = {k: torch.equal(v, outs["streamed"]) for k, v in outs.items()}
    log(f"14b TeaCache replays (calc {want_calc}, the last step cond-only): "
        + ", ".join(f"{k} {v['s']:.2f} s" for k, v in stats.items())
        + f"; latents equal to the streamed loop's: {same}")
    if not all(same.values()) or not torch.isfinite(outs["streamed"]).all():
        raise AssertionError(f"14b TeaCache replays differ: {same}")
    return stats


def dit14b_phase(dev, smi):
    """The 14B (dim 5120, ffn 13824, 40 heads, 40 layers) on one card.
    First its two DiTs' blocks streamed from pinned host memory
    (``build_dits_14b``). Checks, each fatal: the DiT with K1 against the
    plain attention on a small input; one CFG-doubled step at 49 frames of
    368x512 streamed and with the same block bytes resident on the card
    give the same bits (each timed, median of STEPS_14B warm; the resident
    one profiled); TeaCache replays give the same bits streamed and
    resident (``teacache_replay_14b``); the block copies alone timed;
    ``run_two_stage`` through the streamed pipelines (``two_stage_14b``).
    Then ``run_two_stage`` again with both DiTs resident in fp8 beside the
    towers, as ``--fp8_weights`` holds them (``build_fp8_dits_14b``).
    Returns ({path: K1/K4 launches of its ``run_two_stage``}, stats)."""
    import gc

    import torch
    from torch import nn

    from more4d_tpu_torch.config import VAEConfig
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.models import WanVAE
    from more4d_tpu_torch.utils.flops import dit_forward_flops
    from more4d_tpu_torch.utils.profiling import host_memory_gib

    stats = dict(host_memory_gib(), pinned_h2d_gb_s=pinned_bandwidth(dev))
    log(f"14b: host memory " + ", ".join(
        f"{k} {v:.1f} GiB" for k, v in host_memory_gib().items())
        + f"; pinned host -> card {stats['pinned_h2d_gb_s']:.2f} GB/s (one "
          f"1 GiB copy) on {smi}")
    dits, gen = build_dits_14b(dev, stats)
    with torch.device(dev):
        vae = WanVAE(VAEConfig(dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)).init_weights(
            gen).to(torch.bfloat16)
    sd = dits["motion"]
    stats["dit_vs_plain_rel_err"] = check_dit_against_plain(
        sd.model, dev, backbone=sd.backbone, label="14B")

    cfg = sd.cfg
    x, t, ctx, kw = dit_step_inputs(cfg, dev)
    y, clip, mpm = kw["y"], kw["clip_fea"], kw["mpm_features"]
    tokens = x.shape[1] * (H // 16) * (W // 16)
    flops = dit_forward_flops(cfg, tokens, batch=2)

    def timed(fn):
        """(output, median seconds, peak GiB) of STEPS_14B warm runs."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(STEPS_14B):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return (out, float(np.median(secs)),
                torch.cuda.max_memory_allocated() / 2 ** 30, secs)

    flash_attention_cuda.launches = 0
    streamed, s_streamed, peak_streamed, all_s = timed(
        lambda: sd(x, t, ctx, **kw))
    k1_step = flash_attention_cuda.launches / (STEPS_14B + 1)
    copy_ms = cuda_ms(sd.copy_blocks, 2)
    sd.model.blocks = sd.device_blocks()
    with torch.no_grad():
        resident, s_resident, peak_resident, all_r = timed(
            lambda: sd.model(x, t, ctx, **kw))
        # where the compute goes (no copies overlap it here)
        stats["profile_resident_fp8_step"] = profile_phase(
            {"14B step, blocks resident in fp8": lambda: sd.model(
                x, t, ctx, **kw)})
    stats["teacache_replay"] = teacache_replay_14b(
        dev, sd, vae, x[:1], ctx[:1], ctx[1:],
        dict(y=y[:1], clip_fea=clip[:1], mpm_features=mpm[:1]))
    sd.model.blocks = nn.ModuleList()
    gc.collect()
    torch.cuda.empty_cache()
    same = torch.equal(streamed, resident)
    overlap = 1.0 - (s_streamed - s_resident) / (copy_ms / 1e3)
    stats.update(step_streamed_s=s_streamed, step_resident_fp8_s=s_resident,
                 step_streamed_all_s=all_s, step_resident_fp8_all_s=all_r,
                 block_copies_ms=copy_ms, overlap_share=overlap,
                 step_tflops=flops / s_streamed / 1e12,
                 step_tflops_resident=flops / s_resident / 1e12,
                 peak_streamed_step_gib=peak_streamed,
                 peak_resident_fp8_step_gib=peak_resident,
                 k1_per_step=k1_step, dit_forward_flops=flops)
    log(f"14b: CFG-doubled step, batch 2 x {tokens} tokens: streamed "
        f"{s_streamed:.3f} s (runs {[round(v, 3) for v in all_s]}), blocks "
        f"resident in fp8 {s_resident:.3f} s (runs "
        f"{[round(v, 3) for v in all_r]}); the 40 block copies alone "
        f"{copy_ms:.1f} ms ({sum(hb.flat.numel() for hb in sd.host_blocks) / copy_ms / 1e6:.2f} GB/s); "
        f"overlap share {overlap:.3f}; {flops / 1e12:.1f} TFLOP a step, "
        f"{flops / s_streamed / 1e12:.1f} TFLOP/s streamed "
        f"({flops / s_streamed / BF16_FLOPS:.3f} of 989), "
        f"{flops / s_resident / 1e12:.1f} resident; peak {peak_streamed:.2f} "
        f"GiB streamed, {peak_resident:.2f} GiB resident; K1 {k1_step:.0f} a "
        f"step; outputs identical: {same}; on {smi}")
    if not same:
        diff = (streamed.float() - resident.float()).abs().max().item()
        raise AssertionError(f"14B streamed and resident fp8 steps differ "
                             f"(max |diff| {diff:.3e})")
    if k1_step != 3 * cfg.num_layers:
        raise AssertionError(f"14B step launched {k1_step} K1, expected "
                             f"{3 * cfg.num_layers}")
    if not torch.isfinite(streamed).all():
        raise AssertionError("14B step: non-finite velocity")
    del streamed, resident, x, y, ctx, clip, mpm

    towers = build_towers(dev)
    launches = {}
    launches["run_two_stage_14b"], stats["run_two_stage_streamed"] = \
        two_stage_14b(dev, smi, {n: s.model for n, s in dits.items()},
                      towers, vae, streamed=dits)
    gc.collect()
    torch.cuda.empty_cache()
    _, stats["vism14b"] = vism14b_phase(dev, smi, dits["inp"], vae, towers)
    del dits, sd
    gc.collect()
    torch.cuda.empty_cache()
    release_pinned()

    models = build_fp8_dits_14b(dev, gen, stats)
    log(f"14b fp8_weights: both DiTs' weights {stats['fp8_dits_gib']:.2f} "
        f"GiB on the card; {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated with the towers and the VAE")
    launches["run_two_stage_14b_fp8"], stats["run_two_stage_fp8"] = \
        two_stage_14b(dev, smi, models, towers, vae)
    del models, towers, vae
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def two_stage_14b(dev, smi, dits, towers, vae, streamed=None):
    """``run_two_stage`` at 14B with the towers, UniDepth's depth and
    TeaCache (the 14B coefficients, ``offload_residual`` on: the resident
    loop parks its residual in pinned host memory, the streamed loop keeps
    it on the card as the JAX package's does), 2 steps a stage and 2
    trajectories in one stage-2 call denoised one at a time, on the DiTs
    ``dits`` ({'motion', 'inp'}: WanDiT), through ``streamed`` ({'motion',
    'inp'}: their StreamedDiT) when given. Fails unless the outputs are
    finite and in range, K1 launched 120 a calc step and K4 one a
    trajectory. Returns (launches, stats with the peak memory by stage)."""
    import gc

    import torch

    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.infer import (build_encoders, make_two_stage_models,
                                        run_two_stage)
    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda
    from more4d_tpu_torch.models import UniDepthProvider, VAEDecoderAdaptor
    from more4d_tpu_torch.pipelines import (TEACACHE_COEFFICIENTS,
                                            TeaCacheConfig)

    mode = "streamed" if streamed else "fp8_weights"
    cfg = dits["motion"].cfg
    encoders = build_encoders(t5=towers["t5"], tokenize=stand_in_tokenize,
                              clip=towers["clip"], omnimae=towers["omnimae"],
                              device=dev)
    with torch.device(dev):
        adaptor = VAEDecoderAdaptor()
    pcfg = PipelineConfig(num_inference_steps=STEPS, num_frames=FRAMES,
                          height=H, width=W)
    teacache = TeaCacheConfig(tuple(TEACACHE_COEFFICIENTS["wan2.1-fun-14b"]),
                              rel_l1_thresh=0.10, num_skip_start_steps=5,
                              offload_residual=True)
    m = make_two_stage_models(
        dits["motion"], dits["inp"], vae, adaptor, encoders, pcfg,
        device=dev, teacache=teacache,
        estimate_depth=UniDepthProvider(model=towers["unidepth"],
                                        device=dev))
    for pipe, name in ((m.control_pipeline, "motion"),
                       (m.inpaint_pipeline, "inp")):
        if streamed:
            streamed[name].rope_tables = pipe.rope_tables
            pipe.streamed_dit = streamed[name]
    image = np.random.RandomState(0).rand(H, W, 3).astype(np.float32)
    k5 = _zero_counters()["rownorm"]
    splat_cuda.launches = 0
    timings, peaks = {}, {}
    t0 = time.perf_counter()
    with peaks_by_stage(peaks):
        out = run_two_stage(m, image, PROMPT, trajectory_types=[
            ("static", {}), ("circle_rotating", {})], stage2_batch=2,
            stage2_denoise_group=1, timings=timings)
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention_cuda.launches,
                "gs_splat": splat_cuda.launches, "rownorm": k5.launches}
    k6_check(f"run_two_stage_14b {mode}", _k6_counts(), fp8=True)
    calc = [c for p in (m.control_pipeline, m.inpaint_pipeline)
            for _, _, c in p.teacache_state.log]
    want = {"flash_attention": 3 * cfg.num_layers * STEPS * (1 + 2),
            "gs_splat": 2,
            "rownorm": K5_PER_BLOCK * cfg.num_layers * STEPS * (1 + 2)}
    log(f"14b {mode}: run_two_stage {wall:.2f} s (stage 1 {timings['stage1_s']:.2f}"
        f" s with the towers and the depth estimate, render "
        f"{timings['render_s']:.2f} s, stage 2 {timings['stage2_s']:.2f} s "
        f"for 2 trajectories denoised one at a time); peak memory by stage "
        + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items())
        + f"; launches {launches}, expected {want} (K1 120 a calc step, K4 "
          f"one a trajectory, K5 320 a calc step); K5 by epilogue "
          f"{dict(k5.epilogues)}; TeaCache calc of the last loops {calc}; "
          f"on {smi}")
    if launches != want or not all(calc):
        raise AssertionError(f"14b run_two_stage: launches {launches}, "
                             f"expected {want}; calc {calc}")
    k5_check(f"run_two_stage_14b {mode}", launches)
    coords, colors = out["coords"], out["colors"]
    if not (coords.shape == (FRAMES, H * W, 3)
            and torch.isfinite(coords).all()
            and torch.isfinite(colors).all()):
        raise AssertionError("14b: clouds not finite or of the wrong shape")
    for v in out["videos"]:
        vid = v["video"]
        if vid.shape != (FRAMES, H, W, 3) or not torch.isfinite(vid).all() \
                or vid.min() < 0 or vid.max() > 1:
            raise AssertionError(f"14b video {v['name']}")
    stats = dict(run_two_stage_s=wall, **timings, **peaks,
                 run_two_stage_launches=launches)
    del m, out, encoders, adaptor
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def release_pinned():
    """Hand the pinned blocks torch's host allocator keeps cached back to
    the host (``torch.accelerator.empty_host_cache``, or its older name)."""
    import torch

    fn = (getattr(getattr(torch, "accelerator", None), "empty_host_cache",
                  None) or getattr(torch._C, "_host_emptyCache", None))
    if fn is not None:
        fn()


# ------------------------------------------------------------ training path

STRAAG_STEPS = 3           # the 'nothing' run; each other policy runs 2
STRAAG_POLICIES = ("flash_lite", "flash", "flash_offload")
STRAAG_VALIDATION_STEPS = 20
# main(argv)'s depth: its checkpoint holds the fp32 params, AdamW and EMA
# (25.59 GiB at all 30 layers, written and read back ~87 s), so the run
# through the CLI's files, checkpoint and resume is cut to 6 of the 1.3B's
# 30 blocks; the step itself runs at 30 layers in the runs before it
STRAAG_MAIN_LAYERS = 6


def synthetic_scene(seed, frames=FRAMES, h=H, w=W):
    """A scene-flow pickle's content made from a numpy seed: (coords [F,
    H, W, 3], colors [H, W, 3] in [0, 255]), the pixels of a random depth
    map (1-6 m) lifted through a pinhole camera, drifting by a per-pixel
    velocity over the frames."""
    rs = np.random.RandomState(seed)
    depth = 1.0 + 5.0 * rs.rand(h, w)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    focal = 0.5 * w
    pts = np.stack([(xs - w / 2) / focal * depth,
                    (ys - h / 2) / focal * depth, depth], -1)
    vel = 0.01 * rs.randn(1, 1, 1, 3) + 0.002 * rs.randn(1, h, w, 3)
    coords = pts[None] + np.arange(frames)[:, None, None, None] * vel
    colors = 255.0 * rs.rand(h, w, 3)
    return coords.astype(np.float32), colors.astype(np.float32)


def synthetic_sample(seed, frames=FRAMES, h=H, w=W):
    """``synthetic_scene`` through the port's data preparation."""
    from more4d_tpu_torch.data import prepare_straag_sample

    return prepare_straag_sample(*synthetic_scene(seed, frames, h, w),
                                 max_num_frames=frames)


def straag_args(out_dir, *extra):
    """The STraG CLI's arguments at its defaults (``build_parser``) for
    ``run_training``, at the 1.3B, no checkpoint before the run ends."""
    from more4d_tpu_torch.scripts.train_straag import build_parser

    return build_parser().parse_args(
        ["--data_dir", "-", "--pretrained_ckpt", "-", "--vae_ckpt", "-",
         "--encoder_adaptor", "-", "--model_size", "1.3b", "--output_dir",
         out_dir, "--checkpointing_steps", "1000", "--height", str(H),
         "--width", str(W), "--num_frames", str(FRAMES), *extra])


def build_straag_dit(dev, policy="nothing", seed=0):
    """The 1.3B 4D-STraG DiT as the STraG CLI builds it (in_dim 64, i2v,
    motion guidance, remat on every block under ``policy``; fp32 params,
    bf16 compute), random weights from ``seed``; the zero-initialised
    output head and FiLM projections and gates drawn N(0, 0.02), as a
    fine-tune's checkpoint has them trained (at zero the blocks would get
    no gradient). The same seed gives the same bits."""
    import torch

    from more4d_tpu_torch.config import dit_1_3b
    from more4d_tpu_torch.models import WanDiT

    cfg = dit_1_3b(motion_guidance=True, in_dim=64, model_type="i2v",
                   remat=True, remat_policy=policy)
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.device(dev):
        dit = WanDiT(cfg).init_weights(gen)
    _draw_zero_init(dit, gen)
    return dit


def encoder_adaptor(dev, seed):
    """The encoder adaptor with its default initialisation drawn from
    ``seed`` and its zero output conv drawn N(0, 0.02) (as a trained one
    has it: at zero every flow gives the same latents), on ``dev``."""
    import torch

    from more4d_tpu_torch.models import VAEEncoderAdaptor

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = VAEEncoderAdaptor()
        with torch.no_grad():
            enc.conv_out.weight.normal_(0.0, 0.02)
    return enc.to(dev)


@contextlib.contextmanager
def straag_instrumented(peaks=None):
    """The STraG harness logs every step (its runs log step 1 and every
    50th; the CLI has no flag for it), so each step's loss and grad norm
    can be compared; with ``peaks`` ({"prepare": [], "step": []}) the peak
    memory of each train step, and of what ran since the step before (the
    batch preparation), is appended there, GiB."""
    import functools

    import torch

    from more4d_tpu_torch.train import harness

    real_cfg, real_step = harness.StraagRunConfig, harness.train_step

    def step(*a, **k):
        torch.cuda.synchronize()
        peaks["prepare"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        out = real_step(*a, **k)
        torch.cuda.synchronize()
        peaks["step"].append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return out

    harness.StraagRunConfig = functools.partial(real_cfg, log_steps=1)
    if peaks is not None:
        harness.train_step = step
    try:
        yield
    finally:
        harness.StraagRunConfig, harness.train_step = real_cfg, real_step


@contextlib.contextmanager
def straag_batches(recorded, diffs=None):
    """Each ``StraagTrainer.prepare_batch`` call of the runs inside is
    recorded into ``recorded`` (``diffs`` None), or, with ``diffs``, still
    made (its dropout draws taken) but replaced by the recorded batch of
    the same step, and {tensor: (its largest difference from the recorded
    one, the recorded one's largest magnitude)} appended to ``diffs``: so
    that runs under other remat policies take the same
    inputs, whatever the VAE's and the towers' kernels pick on a card
    whose memory is otherwise filled."""
    from more4d_tpu_torch.train import harness

    real = harness.StraagTrainer.prepare_batch
    step = iter(range(len(recorded))) if diffs is not None else None

    def prepare(self, *a, **k):
        batch = real(self, *a, **k)
        if diffs is None:
            recorded.append(batch)
            return batch
        want = recorded[next(step)]
        diffs.append({n: ((batch[n].float() - want[n].float()).abs().max()
                          .item(), want[n].float().abs().max().item())
                      for n in want})
        return want

    harness.StraagTrainer.prepare_batch = prepare
    try:
        yield
    finally:
        harness.StraagTrainer.prepare_batch = real


def straag_run(label, dit, vae, enc, encoders, args, batches, dev,
               **kw):
    """One ``run_training`` of the STraG CLI, counted and timed: returns
    (trainer, launches, stats with each step's loss, grad norm, updated,
    seconds and the run's peak memory)."""
    import torch

    from more4d_tpu_torch.scripts.train_straag import run_training

    shutil.rmtree(args.output_dir, ignore_errors=True)
    timings, peaks = [], {"prepare": [], "step": []}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    allocs = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    with straag_instrumented(peaks):
        trainer, launches = _run_counted(lambda: run_training(
            dit, vae, enc, encoders, iter(batches), args, device=dev,
            timings=timings, **kw))
    torch.cuda.synchronize()
    peak = max(peaks["prepare"] + peaks["step"]
               + [torch.cuda.max_memory_allocated() / 2 ** 30])
    # the caching allocator's calls to the driver in the run (each
    # cudaFree waits for the card) and its retries after freeing its cache
    after = torch.cuda.memory_stats()
    allocator = {k: after.get(k, 0) - allocs.get(k, 0)
                 for k in ("num_alloc_retries", "num_device_alloc",
                           "num_device_free")}
    records = [r for r in _metrics(args.output_dir) if "train/loss" in r]
    n = len(records)
    stats = dict(losses=[r["train/loss"] for r in records],
                 grad_norms=[r["train/grad_norm"] for r in records],
                 updated=[r["train/updated"] for r in records],
                 step_s=[t["step_s"] for t in timings],
                 prepare_s=[t["prepare_s"] for t in timings],
                 validation_s=[t["validation_s"] for t in timings
                               if "validation_s" in t],
                 resident_before_gib=resident, step_peak_gib=peaks["step"],
                 allocator=allocator,
                 prepare_peak_gib=peaks["prepare"],
                 peak_gib=peak, launches=launches,
                 launches_per_step={k: v / max(n, 1)
                                    for k, v in launches.items()})
    log(f"straag {label}: losses {stats['losses']}, grad norms "
        f"{stats['grad_norms']}, updated {stats['updated']}; steps "
        f"{[round(v, 3) for v in stats['step_s']]} s, prepare_batch "
        f"{[round(v, 3) for v in stats['prepare_s']]} s; peak of each "
        f"prepare_batch {[round(v, 2) for v in peaks['prepare']]} and "
        f"step {[round(v, 2) for v in peaks['step']]} GiB, of the run "
        f"{peak:.2f} GiB ({resident:.2f} resident before it); allocator "
        f"{allocator}; launches {launches}")
    if n != args.max_steps or not all(np.isfinite(stats["losses"])):
        raise AssertionError(f"straag {label}: losses {stats['losses']}")
    for name, c in launches.items():
        if c <= 0 and not name.startswith(("rownorm", K6)):
            raise AssertionError(f"straag {label}: kernel {name} was not "
                                 f"launched")
    if not args.validation_steps:      # the validation's sampling takes K5
        k5_check(f"straag {label}", launches, grad=True, epilogues=False)
    k6_check(f"straag {label}", launches, fp8=False)
    return trainer, launches, stats


def straag_step_fn(trainer, batch):
    """One more train step of ``trainer`` on ``batch`` (for a profile)."""
    from more4d_tpu_torch.train.train_straag import draw, train_step

    def step():
        idx, noise = draw(trainer.tcfg, batch, trainer.generator)
        train_step(trainer.dit, trainer.update, trainer.ema, trainer.tcfg,
                   batch, idx, noise, trainer.global_step)

    return step


def straag_policy_turns(trainer, batch, rounds=3):
    """Warm train steps of one trainer under each remat policy in turns
    ('nothing' and STRAAG_POLICIES, ``rounds`` times, the policy switched
    on the DiT's config between steps), each timed on the host with the
    card synchronised: {policy: [seconds]}, in one process on one card."""
    import dataclasses

    import torch

    dit, times = trainer.dit, {}
    step = straag_step_fn(trainer, batch)
    for _ in range(rounds):
        for policy in ("nothing",) + STRAAG_POLICIES:
            dit.cfg = dataclasses.replace(dit.cfg, remat_policy=policy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.setdefault(policy, []).append(time.perf_counter() - t0)
    log("straag warm steps in turns (s): " + ", ".join(
        f"{p} {[round(t, 3) for t in ts]} (median {np.median(ts):.3f})"
        for p, ts in times.items()))
    return times


def straag_cli_phase(dev, smi, towers, ck, root):
    """The 4D-STraG training CLI (``more4d_tpu_torch.scripts.
    train_straag``) at the 1.3B, 49 frames of 368x512, batch 1, on the
    towers' umT5 (stand-in tokenizer), CLIP and OmniMAE in bf16, a bf16
    VAE and synthetic scene flows:

    - ``run_training`` for STRAAG_STEPS AdamW steps at the CLI's defaults
      (remat 'nothing', EMA): K1 180 a step, K2 and K3 90, finite losses,
      params and EMA moved; the DiT's gradients with the kernels against
      the plain attention's; one step and one prepare_batch profiled;
    - 2 steps under each of STRAAG_POLICIES from the same weights and
      draws: the 'nothing' run's losses and grad norms bit for bit, K1 150
      a step;
    - ``--grad_accum_steps 2 --report_model_info``: params and EMA the
      same bits after the first micro-step, one EMA step after the second;
      ``grad_norm/`` keys in metrics.jsonl;
    - one step with ``--validation_steps 1``: 20 steps of the control
      pipeline, K1 90 a CFG-doubled step, its video finite and of the
      pipeline's shape (the gif needs ``imageio``; where it is missing
      that import is caught here and logged);
    - ``main(argv)`` on the synthetic released-layout checkpoints in
      ``ck`` (the Control DiT's first STRAAG_MAIN_LAYERS blocks) and 4
      scene-flow pickles: 2 steps, a checkpoint at step 2, then
      ``--resume`` for a third.

    Returns ({path: launches}, stats)."""
    import gc
    import os
    import pickle

    import torch

    from more4d_tpu_torch.config import VAEConfig
    from more4d_tpu_torch.infer import build_encoders
    from more4d_tpu_torch.kernels import _build
    from more4d_tpu_torch.models import WanVAE
    from more4d_tpu_torch.train import harness

    out = _build.BUILD / "chip_smoke_straag"
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(6)
    with torch.device(dev):
        vae = WanVAE(VAEConfig(dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)).init_weights(
            gen).to(torch.bfloat16)
    enc = encoder_adaptor(dev, 7)
    encoders = build_encoders(t5=towers["t5"], tokenize=stand_in_tokenize,
                              clip=towers["clip"], omnimae=towers["omnimae"],
                              device=dev)
    samples = [synthetic_sample(i) for i in range(STRAAG_STEPS)]
    batches = [([s], [PROMPT]) for s in samples]
    dit = build_straag_dit(dev)
    n_params = sum(p.numel() for p in dit.parameters())
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    log(f"straag: built in {time.perf_counter() - t0:.1f} s: 1.3B 4D-STraG "
        f"DiT ({n_params / 1e9:.3f}e9 params, fp32 params, bf16 compute, "
        f"remat on {len(dit.remat_blocks())} of {dit.cfg.num_layers} "
        f"blocks), Wan VAE bf16, encoder adaptor fp32, umT5-xxl, CLIP and "
        f"OmniMAE from the towers (bf16); {resident:.2f} GiB resident "
        f"with the towers; {STRAAG_STEPS} samples of {FRAMES}x{H}x{W}")
    launches, stats = {}, {}

    watch = ("patch_embedding.weight", "blocks.0.self_attn.q.weight",
             f"blocks.{dit.cfg.num_layers - 1}.ffn.2.weight",
             "head.head.weight")
    before = {n: p.detach().clone() for n, p in dit.named_parameters()
              if n in watch}
    recorded = []
    with straag_batches(recorded):
        trainer, launches["straag_cli"], stats["nothing"] = straag_run(
            f"remat 'nothing', {STRAAG_STEPS} steps", dit, vae, enc,
            encoders, straag_args(str(out / "nothing"), "--max_steps",
                                  str(STRAAG_STEPS)), batches, dev)
    # three attentions a block: K1 in the forward and again in each block's
    # run in the backward, K2 and K3 once (180, 90, 90 at 30 blocks); eight
    # norm sites a block: K5 in both runs, its backward once (480, 240);
    # no fp8 weight, so no K6
    n_blocks = dit.cfg.num_layers
    want = {"flash_attention": 6 * n_blocks,
            "flash_attention_bwd_dq": 3 * n_blocks,
            "flash_attention_bwd_dkv": 3 * n_blocks,
            "rownorm": 2 * K5_PER_BLOCK * n_blocks,
            "rownorm_bwd": K5_PER_BLOCK * n_blocks, K6: 0, K6_WANT: 0}
    if stats["nothing"]["launches_per_step"] != want:
        raise AssertionError(f"straag: launches a step "
                             f"{stats['nothing']['launches_per_step']}, "
                             f"expected {want}")
    params = dict(dit.named_parameters())
    moved = {n: (params[n] - before[n]).abs().max().item() for n in watch}
    ema_moved = {n: (trainer.ema[n] - before[n]).abs().max().item()
                 for n in watch}
    log(f"straag: max |param change| {moved}; max |EMA change| {ema_moved}")
    if not (all(v > 0 for v in moved.values())
            and all(v > 0 for v in ema_moved.values())):
        raise AssertionError("straag: params or EMA did not move")

    check_dit_grads_against_plain(dit, dev)
    torch.cuda.reset_peak_memory_stats()
    batch = trainer.prepare_batch([samples[0]], [PROMPT])
    torch.cuda.synchronize()
    stats["peak_prepare_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    one_step = straag_step_fn(trainer, batch)
    stats["profile"] = profile_phase({
        "straag train step": one_step,
        "straag prepare_batch": lambda: trainer.prepare_batch(
            [samples[0]], [PROMPT])})
    del trainer, dit, params, batch, before, one_step
    gc.collect()
    torch.cuda.empty_cache()

    ref = stats["nothing"]
    for policy in STRAAG_POLICIES:
        diffs = []
        with straag_batches(recorded, diffs):
            trainer, n, stats[policy] = straag_run(
                f"remat '{policy}', 2 steps", build_straag_dit(dev, policy),
                vae, enc, encoders, straag_args(
                    str(out / policy), "--max_steps", "2", "--remat_policy",
                    policy), batches, dev)
        stats[policy]["batch_max_abs_diff"] = diffs
        if policy == "flash":
            launches["straag_cli_flash"] = n
        same = (stats[policy]["losses"] == ref["losses"][:2]
                and stats[policy]["grad_norms"] == ref["grad_norms"][:2])
        stats[policy]["same_bits_as_nothing"] = same
        log(f"straag {policy}: on the 'nothing' run's batches (a fresh "
            f"prepare_batch differs from them by {diffs}), losses and grad "
            f"norms {'the same bits as' if same else 'DIFFER from'} "
            f"'nothing''s first 2 steps; K1 {stats[policy]['launches_per_step']} a "
            f"step; step peak {max(stats[policy]['step_peak_gib']):.2f} "
            f"GiB against {max(ref['step_peak_gib']):.2f}")
        if not same:
            raise AssertionError(f"straag {policy}: not the 'nothing' run's "
                                 f"losses and grad norms")
        # the backward's runs skip the self-attention: 150 at 30 blocks
        if stats[policy]["launches_per_step"] != dict(
                want, flash_attention=5 * n_blocks):
            raise AssertionError(f"straag {policy}: launches a step "
                                 f"{stats[policy]['launches_per_step']}")
        if policy == "flash_lite":
            stats["profile_flash_lite"] = profile_phase({
                "straag train step, remat 'flash_lite'": straag_step_fn(
                    trainer, recorded[0])})
        if policy == STRAAG_POLICIES[-1]:
            stats["turns"] = straag_policy_turns(trainer, recorded[0])
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    del recorded

    # accumulation: the first micro-step through the CLI's loop, the second
    # through the same trainer's train(), the state checked between
    dit = build_straag_dit(dev)
    p0 = {n: p.detach().clone() for n, p in dit.named_parameters()
          if n in watch}
    args = straag_args(str(out / "accum"), "--max_steps", "1",
                       "--grad_accum_steps", "2", "--report_model_info",
                       "--lr_warmup_steps", "0", "--ema_decay", "0.9")
    trainer, first, stats["accum"] = straag_run(
        "--grad_accum_steps 2, micro-step 1", dit, vae, enc, encoders, args,
        batches, dev)
    params = dict(dit.named_parameters())
    still = all(torch.equal(params[n], p0[n]) and torch.equal(
        trainer.ema[n], p0[n]) for n in watch)
    trainer.run_cfg.max_steps = 2
    with straag_instrumented():
        second = _run_counted(lambda: trainer.train(iter(batches[1:])))[1]
    launches["straag_cli_accum"] = {k: first[k] + second[k] for k in first}
    records = _metrics(args.output_dir)
    updated = [r["train/updated"] for r in records if "train/updated" in r]
    gn_keys = sorted({k for r in records for k in r
                      if k.startswith("grad_norm/")})
    moved = {n: (params[n] - p0[n]).abs().max().item() for n in watch}
    one_ema_step = max(
        ((trainer.ema[n] - (0.9 * p0[n] + 0.1 * params[n])).abs().max()
         / params[n].abs().max()).item() for n in watch)
    stats["accum"].update(updated=updated, n_grad_norm_keys=len(gn_keys),
                          ema_one_step_rel_err=one_ema_step)
    log(f"straag accum: updated {updated}; after micro-step 1 params and "
        f"EMA {'unchanged' if still else 'CHANGED'}; after micro-step 2 "
        f"max |param change| {moved}, EMA against one decay step "
        f"{one_ema_step:.2e} (relative); {len(gn_keys)} grad_norm/ keys "
        f"({gn_keys[:2]}...); launches {launches['straag_cli_accum']}")
    if not (still and updated == [0.0, 1.0] and all(
            v > 0 for v in moved.values()) and one_ema_step < 1e-6
            and len(gn_keys) == len(params)):
        raise AssertionError("straag accum: the window did not hold, or the "
                             "grad-norm report is missing")
    del trainer, dit, params
    gc.collect()
    torch.cuda.empty_cache()

    # validation at step 1: the control pipeline for 20 steps
    caught = {}
    real_validate = harness.StraagTrainer._validate

    def validate(self, *a, **k):
        counters = _launch_counters()
        before = {n: c.launches for n, c in counters.items()}
        caught["video"] = real_validate(self, *a, **k)
        caught["launches"] = {n: c.launches - before[n]
                              for n, c in counters.items()}
        return caught["video"]

    from more4d_tpu_torch.utils import artifacts

    real_save = artifacts.save_videos_grid

    def save(path, video, **k):
        try:
            real_save(path, video, **k)
            caught["gif"] = path
        except ImportError as e:        # no imageio on this machine
            caught["gif"] = f"not written: {e}"

    harness.StraagTrainer._validate = validate
    artifacts.save_videos_grid = save
    try:
        trainer, _, stats["validation"] = straag_run(
            "--validation_steps 1, 1 step", build_straag_dit(dev), vae, enc,
            encoders, straag_args(str(out / "validation"), "--max_steps",
                                  "1", "--validation_steps", "1"),
            batches, dev)
    finally:
        harness.StraagTrainer._validate = real_validate
        artifacts.save_videos_grid = real_save
    launches["straag_validation"] = caught["launches"]
    video = caught["video"]
    del trainer
    log(f"straag validation: {stats['validation']['validation_s']} s; "
        f"video {tuple(video.shape)}, range "
        f"[{video.min():.3f}, {video.max():.3f}]; gif {caught['gif']}; "
        f"launches {caught['launches']} (expected K1 {3 * n_blocks} a "
        f"CFG-doubled step x {STRAAG_VALIDATION_STEPS})")
    if not (video.shape == (1, FRAMES, H, W, 3) and np.isfinite(video).all()
            and caught["launches"]["flash_attention"]
            == 3 * n_blocks * STRAAG_VALIDATION_STEPS):
        raise AssertionError("straag validation: wrong video or launches")
    k5_check("straag_validation", caught["launches"], epilogues=False)
    k6_check("straag_validation", caught["launches"], fp8=False)
    del video, caught, vae, enc, encoders
    gc.collect()
    torch.cuda.empty_cache()
    stats["runs_s"] = time.perf_counter() - t0

    # the CLI's main(argv) on released-layout checkpoints and pickles, at
    # STRAAG_MAIN_LAYERS blocks: the Control checkpoint's first blocks
    import functools

    from more4d_tpu_torch import config as tconfig
    from more4d_tpu_torch.scripts.train_straag import main as cli_main
    from more4d_tpu_torch.utils.safetensors_io import load_file, save_file

    ctrl = {}
    for f in sorted(os.listdir(ck["control_dit"][0])):
        ctrl.update(load_file(os.path.join(ck["control_dit"][0], f)))
    cut = os.path.join(root, f"control_{STRAAG_MAIN_LAYERS}.safetensors")
    save_file({k: v for k, v in ctrl.items() if not k.startswith("blocks.")
               or int(k.split(".")[1]) < STRAAG_MAIN_LAYERS}, cut)
    del ctrl
    n_main = STRAAG_MAIN_LAYERS
    data = os.path.join(root, "straag_data")
    os.makedirs(data)
    for i in range(4):
        coords, colors = synthetic_scene(10 + i)
        with open(os.path.join(data, f"clip{i}_dt3d_pred.pkl"), "wb") as f:
            pickle.dump({"coords": coords.reshape(FRAMES, H * W, 3),
                         "colors": colors.reshape(H * W, 3)}, f)
    run_dir = os.path.join(root, "straag_run")
    argv = ["--data_dir", data, "--pretrained_ckpt", cut,
            "--vae_ckpt", ck["vae"][0], "--encoder_adaptor",
            ck["encoder_adaptor"][0], "--clip_ckpt", ck["clip"][0],
            "--omnimae_ckpt", ck["omnimae"][0], "--model_size", "1.3b",
            "--allow_dummy_text", "--output_dir", run_dir,
            "--checkpointing_steps", "2", "--height", str(H), "--width",
            str(W), "--num_frames", str(FRAMES)]
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with straag_instrumented(), _patched(
            tconfig, "dit_1_3b", functools.partial(tconfig.dit_1_3b,
                                                   num_layers=n_main)):
        rc, first = _run_counted(lambda: cli_main(
            argv + ["--max_steps", "2"], device=dev))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        saved = sum(os.path.getsize(os.path.join(run_dir, "2", f))
                    for f in os.listdir(os.path.join(run_dir, "2")))
        extra = json.load(open(os.path.join(run_dir, "2", "extra.json")))
        rc2, second = _run_counted(lambda: cli_main(
            argv + ["--max_steps", "3", "--resume"], device=dev))
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches["straag_cli_main"] = {k: first[k] + second[k] for k in first}
    records = [r for r in _metrics(run_dir) if "train/loss" in r]
    steps = [r["step"] for r in records]
    stats["cli_main"] = dict(
        first_s=t2 - t1, resumed_s=t3 - t2, checkpoint_gib=saved / 2 ** 30,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        losses=[r["train/loss"] for r in records], data_state=extra["data"],
        launches=launches["straag_cli_main"])
    log(f"straag cli main ({n_main} of {n_blocks} blocks): "
        f"{t2 - t1:.1f} s for 2 steps with the load and "
        f"a {saved / 2 ** 30:.2f} GiB checkpoint at step 2 (data state "
        f"{extra['data']}); resumed for step 3 in {t3 - t2:.1f} s; steps "
        f"{steps}, losses {stats['cli_main']['losses']}; peak "
        f"{stats['cli_main']['peak_gib']:.2f} GiB with the towers "
        f"resident; launches {launches['straag_cli_main']} on {smi}")
    if (rc, rc2) != (0, 0) or steps != [1, 2, 3] or not all(
            np.isfinite(stats["cli_main"]["losses"])) or extra[
            "global_step"] != 2:
        raise AssertionError("straag cli main: the run, its checkpoint or "
                             "its resume failed")
    if launches["straag_cli_main"]["flash_attention"] != 3 * 6 * n_main:
        raise AssertionError(f"straag cli main: launches "
                             f"{launches['straag_cli_main']}")
    k6_check("straag_cli_main", launches["straag_cli_main"], fp8=False)
    shutil.rmtree(run_dir, ignore_errors=True)
    shutil.rmtree(data, ignore_errors=True)
    os.remove(cut)
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

    def plain_attention(q, k, v, kv_lens=None, name=""):
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


# ------------------------------------------- ViSM LoRA and adaptor training

VISM_POINTS = 188416       # 368 x 512 pixels lifted to a cloud a frame


def vism_raw_sample(seed, frames=FRAMES, h=H, w=W):
    """The inputs of one ViSM pair, made from a numpy seed: a video in [0,
    1], and a cloud of VISM_POINTS points a frame (each pixel of a random
    1-6 m depth map lifted through the ViSM intrinsics, drifting by a
    per-point velocity, so later frames leave holes) with their colours."""
    from more4d_tpu_torch.data.vism import vism_intrinsics

    rs = np.random.RandomState(seed)
    k = vism_intrinsics(h, w).numpy()
    depth = (1.0 + 5.0 * rs.rand(h * w)).astype(np.float32)
    ys, xs = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                         indexing="ij")
    pts = np.stack([(xs.ravel() - k[0, 2]) / k[0, 0] * depth,
                    (ys.ravel() - k[1, 2]) / k[1, 1] * depth, depth], -1)
    vel = 0.02 * rs.randn(1, 3) + 0.004 * rs.randn(h * w, 3)
    coords = pts[None] + np.arange(frames)[:, None, None] * vel[None]
    return dict(video01=rs.rand(frames, h, w, 3).astype(np.float32),
                coords=coords.astype(np.float32),
                colors=rs.rand(h * w, 3).astype(np.float32))


def vism_samples(dev, n):
    """``n`` ViSM pairs fed as the CLI's ``main`` feeds its loop: a
    generator that makes each pair's raw inputs on the host and runs
    ``prepare_vism_sample`` (the z-buffer projection of every frame on the
    card) with one ``RandomState``, one pair at a time, behind
    ``prefetch``'s two workers. The z-buffer is timed alone in
    ``zbuffer_timing``."""
    from more4d_tpu_torch.data.prefetch import prefetch
    from more4d_tpu_torch.data.vism import prepare_vism_sample

    rng = np.random.RandomState(0)

    def samples():
        for seed in range(n):
            raw = vism_raw_sample(seed)
            yield prepare_vism_sample(
                raw["video01"], PROMPT, coords=raw["coords"],
                colors=raw["colors"], max_num_frames=FRAMES, rng=rng,
                device=dev)

    return prefetch(samples(), depth=4, num_workers=2)


def vism_args(out_dir, **over):
    """The ViSM CLI's arguments at its defaults (``build_parser``), its
    checkpoint past the run unless asked, logging every step."""
    from more4d_tpu_torch.scripts.train_vism import build_parser

    args = build_parser().parse_args(
        ["--data_dir", out_dir, "--pretrained_ckpt", "-", "--vae_ckpt", "-",
         "--output_dir", out_dir, "--log_steps", "1", "--max_steps", "3",
         "--checkpointing_steps", "1000"])
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _launch_counters():
    """The port's launch counters by name: K1-K3, K5 and its backward, K6,
    and what K6 must launch (``Fp8Tensors``, its hook installed here)."""
    from more4d_tpu_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    from more4d_tpu_torch.kernels.rownorm import (rownorm_bwd_cuda,
                                                  rownorm_cuda)
    from more4d_tpu_torch.kernels.widen import widen_fp8_cuda

    Fp8Tensors.install()
    return {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd_dq": flash_bwd_dq_cuda,
            "flash_attention_bwd_dkv": flash_bwd_dkv_cuda,
            "rownorm": rownorm_cuda, "rownorm_bwd": rownorm_bwd_cuda,
            K6: widen_fp8_cuda, K6_WANT: Fp8Tensors}


def _zero_counters():
    """K1-K3's, K5's (forward and backward) and K6's launch counts, what
    K6 must launch, and K5's by epilogue, set to 0."""
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    counters["rownorm"].epilogues.clear()
    counters["rownorm_bwd"].epilogues.clear()
    return counters


def _run_counted(fn):
    """(fn()'s result, {kernel: launches}) with every count set to 0 just
    before."""
    counters = _zero_counters()
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def _metrics(out_dir):
    import os

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def vism_run(label, dit, vae, encoders, args, dev, n_samples, *,
             fp8=False, **kw):
    """One ``run_training`` of the ViSM CLI over ``n_samples`` prefetched
    pairs, counted and timed, K6 held by ``k6_check`` (``fp8``: the DiT's
    weights are): returns (lora, launches, stats)."""
    import torch

    from more4d_tpu_torch.scripts.train_vism import run_training

    shutil.rmtree(args.output_dir, ignore_errors=True)
    timings = []
    samples = vism_samples(dev, n_samples)
    torch.cuda.reset_peak_memory_stats()
    lora, launches = _run_counted(lambda: run_training(
        dit, vae, encoders.encode_text, samples, args,
        encode_clip=encoders.encode_clip, device=dev, timings=timings,
        **kw))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = [r for r in _metrics(args.output_dir) if "train/loss" in r]
    losses = [r["train/loss"] for r in records]
    warm = timings[1:] or timings
    stats = dict(losses=losses, grad_norms=[r["train/grad_norm"]
                                            for r in records],
                 updated=[r["train/updated"] for r in records],
                 step_s=[t["step_s"] for t in timings],
                 prepare_s=[t["prepare_s"] for t in timings],
                 warm_step_s=float(np.mean([t["step_s"] for t in warm])),
                 warm_prepare_s=float(np.mean([t["prepare_s"]
                                               for t in warm])),
                 peak_gib=peak, launches=launches)
    log(f"vism {label}: losses {losses}, grad norms {stats['grad_norms']}, "
        f"updated {stats['updated']}; steps "
        f"{[round(v, 3) for v in stats['step_s']]} s, batch preparation "
        f"{[round(v, 3) for v in stats['prepare_s']]} s; peak "
        f"{peak:.2f} GiB; launches {launches}")
    if len(losses) != args.max_steps or not all(np.isfinite(losses)):
        raise AssertionError(f"vism {label}: losses {losses}")
    for name, n in launches.items():
        # K5 takes the norms whose operands need no gradient: those that
        # run before the first LoRA factor (the first block's adaLN norm)
        if n <= 0 and not name.startswith(("rownorm", K6)):
            raise AssertionError(f"vism {label}: kernel {name} was not "
                                 f"launched")
    k6_check(f"vism {label}", launches, fp8)
    return lora, launches, stats


def build_inp_dit_1_3b(dev, seed=5):
    """The 1.3B InP DiT as the ViSM CLI builds it (in_dim 36, i2v, remat
    on; fp32 params, bf16 compute), random weights from ``seed``, the zero
    output head drawn N(0, 0.02) as a trained checkpoint has it (at zero
    no gradient reaches the blocks)."""
    import torch

    from more4d_tpu_torch.config import dit_1_3b
    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.nn.layers import materialize

    cfg = dit_1_3b(motion_guidance=False, in_dim=36, model_type="i2v",
                   remat=True)
    gen = torch.Generator(dev).manual_seed(seed)
    dit = materialize(lambda: WanDiT(cfg), dev, torch.float32, gen)
    with torch.no_grad():
        dit.head.head.weight.normal_(0.0, 0.02, generator=gen)
    return dit.requires_grad_(False)


def vism_train_phase(dev, towers):
    """The ViSM LoRA CLI's ``run_training`` at 1.3B (the InP DiT, fp32
    params, bf16 compute, remat), 49 frames of 368x512, on the towers'
    umT5 (stand-in tokenizer) and CLIP and a bf16 VAE, its samples made by
    ``prepare_vism_sample`` behind ``prefetch`` (``vism_samples``, as the
    CLI's ``main`` feeds them): 3 AdamW steps with
    ``--export_kohya``; 2 micro-steps of ``--optimizer came
    --grad_accum_steps 2``; 2 steps of ``--train_text_encoder``. K1-K3
    must launch, losses be finite, the factors move, the exported kohya
    file load through ``load_vism_lora`` and merge into the DiT; the
    factors' gradients with the kernels are held against the plain
    attention's, and one step is profiled. Returns (launches by path,
    stats)."""
    import gc
    import os

    import torch

    from more4d_tpu_torch.config import VAEConfig
    from more4d_tpu_torch.convert.lora_torch import load_vism_lora
    from more4d_tpu_torch.infer import build_encoders
    from more4d_tpu_torch.kernels import _build
    from more4d_tpu_torch.models import WanVAE
    from more4d_tpu_torch.scripts.train_vism import prepare_vism_batch
    from more4d_tpu_torch.train.lora import apply_lora
    from more4d_tpu_torch.train.train_straag import draw
    from more4d_tpu_torch.train.optim import GradUpdate, make_adamw
    from more4d_tpu_torch.train.train_vism import (VismTrainConfig,
                                                   factor_leaves, train_step)

    t0 = time.perf_counter()
    dit = build_inp_dit_1_3b(dev)
    gen = torch.Generator(dev).manual_seed(6)
    with torch.device(dev):
        vae = WanVAE(VAEConfig(dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)).init_weights(
            gen).to(torch.bfloat16)
    encoders = build_encoders(t5=towers["t5"], tokenize=stand_in_tokenize,
                              clip=towers["clip"], device=dev)
    torch.cuda.synchronize()
    log(f"vism: built in {time.perf_counter() - t0:.1f} s: 1.3B InP DiT "
        f"({sum(p.numel() for p in dit.parameters()) / 1e9:.3f}e9 params "
        f"fp32, bf16 compute, remat on {len(dit.remat_blocks())} blocks), "
        f"VAE bf16, umT5-xxl and CLIP from the towers (bf16)")
    root = _build.BUILD / "chip_smoke_vism"
    launches, stats = {}, {}

    out = str(root / "adamw")
    lora, launches["vism_1.3b"], stats["adamw"] = vism_run(
        "1.3b AdamW, 3 steps", dit, vae, encoders,
        vism_args(out, export_kohya=True, checkpointing_steps=3), dev, 3)
    up = max(f["up"].abs().max().item() for f in lora["factors"].values())
    log(f"vism: {len(lora['factors'])} factor pairs, rank "
        f"{lora['rank']}, max |up| after 3 steps {up:.3e} (0 at init)")
    if not up > 0:
        raise AssertionError("vism: the LoRA's up factors did not move")
    kohya = load_vism_lora(os.path.join(out, "lora_kohya.safetensors"))
    name = "blocks.0.self_attn.q.weight"
    if set(kohya["factors"]) != set(lora["factors"]) or not torch.equal(
            kohya["factors"][name]["up"],
            lora["factors"][name]["up"].detach().cpu()):
        raise AssertionError("vism: the kohya export does not give the "
                             "trained factors back")
    base = dit.state_dict()
    merged = apply_lora(base, kohya)
    changed = sum(not torch.equal(merged[k], base[k]) for k in base)
    delta = (merged[name] - base[name]).abs().max().item()
    want = (kohya["alpha"] / kohya["rank"]
            * kohya["factors"][name]["up"].to(dev)
            @ kohya["factors"][name]["down"].to(dev))
    err = (merged[name] - base[name] - want).abs().max().item()
    log(f"vism: the kohya export loads through load_vism_lora (rank "
        f"{kohya['rank']}, alpha {kohya['alpha']}) and merges into the InP "
        f"DiT: {changed} of {len(base)} tensors changed, max |W' - W| "
        f"{delta:.3e} on {name}, |W' - W - s up down| {err:.3e}")
    if not (delta > 0 and err < 1e-6 and changed == len(kohya["factors"])):
        raise AssertionError("vism: the exported LoRA does not merge")
    del lora, kohya, merged, base

    lora, launches["vism_1.3b_came_accum"], stats["came_accum2"] = vism_run(
        "1.3b CAME, grad_accum_steps 2", dit, vae, encoders,
        vism_args(str(root / "came"), optimizer="came", grad_accum_steps=2,
                  max_steps=2), dev, 2)
    if stats["came_accum2"]["updated"] != [0.0, 1.0]:
        raise AssertionError("vism: accumulation over 2 micro-steps must "
                             "update on the second only")
    del lora

    lora, launches["vism_1.3b_te"], stats["te"] = vism_run(
        "1.3b --train_text_encoder", dit, vae, encoders,
        vism_args(str(root / "te"), train_text_encoder=True, max_steps=2),
        dev, 2, text_encoder=towers["t5"], tokenize=stand_in_tokenize)
    te_up = max(f["up"].abs().max().item()
                for f in lora["te"]["factors"].values())
    log(f"vism te: {len(lora['te']['factors'])} umT5 factor pairs, max "
        f"|up| {te_up:.3e} after 2 steps")
    if not te_up > 0:
        raise AssertionError("vism te: the umT5 LoRA did not move")
    del lora
    gc.collect()
    torch.cuda.empty_cache()

    stats["grad_rel_err"] = check_lora_grads_against_plain(dit, dev)

    # one resident step, profiled
    tcfg = VismTrainConfig()
    sample = next(vism_samples(dev, 1))
    batch = prepare_vism_batch(sample, vae, encoders.encode_text,
                               encoders.encode_clip)
    from more4d_tpu_torch.train.lora import create_lora

    lora = create_lora(dit.state_dict(), torch.Generator(dev).manual_seed(1),
                       rank=4, alpha=4.0)
    opt, _ = make_adamw(factor_leaves(lora), 1e-4)
    update = GradUpdate(factor_leaves(lora), opt)
    g = torch.Generator(dev).manual_seed(2)

    def one_step():
        idx, noise = draw(tcfg, batch, g)
        train_step(dit, update, tcfg, lora, batch, idx, noise)

    stats["zbuffer"] = zbuffer_timing(dev)
    stats["profile"] = profile_phase({
        "vism step 1.3b": one_step,
        "vism prepare_vism_batch": lambda: prepare_vism_batch(
            sample, vae, encoders.encode_text, encoders.encode_clip)})
    del dit, vae, encoders, lora, opt, update, batch, sample
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


def zbuffer_timing(dev):
    """The z-buffer alone on an idle card (CUDA events): one frame's
    ``project_point_cloud`` of VISM_POINTS points, and a whole
    ``prepare_vism_sample`` of FRAMES frames from inputs already on the
    card (in the training loop it runs in a prefetch worker, its kernels
    queued behind the step's)."""
    import torch

    from more4d_tpu_torch.data.vism import (prepare_vism_sample,
                                            project_point_cloud)

    raw = {k: torch.from_numpy(v).to(dev)
           for k, v in vism_raw_sample(0).items()}
    frame_ms = cuda_ms(lambda: project_point_cloud(
        raw["coords"][FRAMES - 1], raw["colors"], H, W), 10)
    sample_ms = cuda_ms(lambda: prepare_vism_sample(
        raw["video01"], PROMPT, coords=raw["coords"], colors=raw["colors"],
        max_num_frames=FRAMES, rng=np.random.RandomState(0), device=dev), 3)
    log(f"vism z-buffer: {frame_ms:.3f} ms a frame of {VISM_POINTS} points, "
        f"{sample_ms:.1f} ms a sample's {FRAMES} frames with the rest of "
        f"prepare_vism_sample")
    return dict(frame_ms=frame_ms, sample_ms=sample_ms)


def check_lora_grads_against_plain(dit, dev):
    """The ViSM step's factor gradients with K1, K2 and K3 against those
    with the plain attention forward and backward, on a small input (2
    latent frames of 8x8), the factors' up drawn so every factor gets a
    gradient: relative error of the whole gradient under 5e-2, as
    ``check_dit_grads_against_plain`` holds the DiT's."""
    import importlib

    import torch

    from more4d_tpu_torch.kernels import flash_attention as fa
    from more4d_tpu_torch.train.lora import create_lora
    from more4d_tpu_torch.train.train_vism import (VismTrainConfig,
                                                   loss_and_grads)

    attn_mod = importlib.import_module("more4d_tpu_torch.nn.attention")
    x, t, ctx, y, clip, _ = small_dit_inputs(dit.cfg, dev, 4)
    batch = {"latents": x, "y": y, "context": ctx, "clip_fea": clip}
    g = torch.Generator(dev).manual_seed(9)
    lora = create_lora(dit.state_dict(), g, rank=4, alpha=4.0)
    with torch.no_grad():
        for f in lora["factors"].values():
            f["up"].normal_(0.0, 0.01, generator=g)
    idx = torch.tensor([500], device=dev)
    noise = torch.randn(x.shape, generator=g, device=dev)
    cfg = VismTrainConfig()

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

    def plain_attention(q, k, v, kv_lens=None, name=""):
        if k.shape[1] == 0:
            return torch.zeros_like(q)
        return PlainFlash.apply(q, k, v, kv_lens)

    (_, got), calls = _run_counted(
        lambda: loss_and_grads(dit, cfg, lora, batch, idx, noise))
    real = attn_mod.flash_attention
    attn_mod.flash_attention = plain_attention
    try:
        with exact_fp32():
            (_, want), stray = _run_counted(
                lambda: loss_and_grads(dit, cfg, lora, batch, idx, noise))
    finally:
        attn_mod.flash_attention = real
    # the norms and the widening, not the attention
    for k in ("rownorm", "rownorm_bwd", K6, K6_WANT):
        del calls[k], stray[k]
    num = sum((a - b).float().square().sum() for a, b in zip(got, want))
    den = sum(b.float().square().sum() for b in want)
    rel = (num.sqrt() / den.sqrt().clamp_min(1e-30)).item()
    log(f"ViSM LoRA gradients with K1/K2/K3 ({calls} launches) vs with the "
        f"plain attention ({stray} launches), 1x2x8x8 latents, "
        f"{len(got)} factor tensors: relative error {rel:.3e} (tol 5e-2)")
    if min(calls.values()) == 0 or any(stray.values()):
        raise AssertionError("the LoRA gradient comparison did not switch "
                             "between the kernels and the plain attention")
    if not (all(torch.isfinite(a).all() for a in got) and rel < 5e-2):
        raise AssertionError(f"ViSM LoRA gradients with the kernels "
                             f"disagree with the plain attention: {rel:.3e}")
    return rel


VISM14B_CHECK_LAYERS = 3   # full-width blocks in the streamed-vs-resident
VISM14B_REL_TOL = 2e-2     # check (3, so a buffer takes a second block);
                           # bf16 merged weight against the side path


def resident_blocks_trainer(trainer):
    """A copy of ``trainer`` (a ``StreamedLoRATrainer``) that walks its
    blocks copied to the card once, at their storage dtypes: the same step
    with no copies, for the overlap share and the bit-for-bit check of
    the streamed walk."""
    import copy

    res = copy.copy(trainer)
    res._blocks = list(trainer.device_blocks())
    res._copy = res._flats = res._slots = None
    res._hook(res._blocks)
    return res


def vism14b_phase(dev, smi, sd, vae, towers):
    """The ViSM CLI's ``--offload_blocks`` path at 14B on the InP DiT's
    pinned fp8 blocks (``sd``, a ``StreamedDiT``): ``run_training`` for 3
    steps at 49 frames of 368x512 (K1 240, K2 120 and K3 120 a step); the
    same step with the blocks resident on the card
    (``resident_blocks_trainer``), for the overlap share and held to the
    streamed step bit for bit over all the blocks (loss, gradient norm and
    the factors after each of 3 AdamW steps); and, on the first
    VISM14B_CHECK_LAYERS blocks at full width, the
    streamed step's loss and factor gradients against the resident LoRA
    step (``train_vism``, weights merged in bf16) and against itself with
    ``acts_on_host``. Returns (launches, stats)."""
    import dataclasses
    import gc

    import torch

    from more4d_tpu_torch.infer import build_encoders
    from more4d_tpu_torch.kernels import _build
    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.nn.layers import from_state_dict
    from more4d_tpu_torch.scripts.train_vism import prepare_vism_batch
    from more4d_tpu_torch.train.lora import create_lora
    from more4d_tpu_torch.train.lora_streamed import StreamedLoRATrainer
    from more4d_tpu_torch.train.train_straag import draw
    from more4d_tpu_torch.train.optim import GradUpdate, make_adamw
    from more4d_tpu_torch.train.train_vism import (VismTrainConfig,
                                                   factor_leaves,
                                                   loss_and_grads)

    encoders = build_encoders(t5=towers["t5"], tokenize=stand_in_tokenize,
                              clip=towers["clip"], device=dev)
    pinned = sum(hb.flat.numel() for hb in sd.host_blocks)
    root = _build.BUILD / "chip_smoke_vism14b"
    lora, launches, run = vism_run(
        "14b --offload_blocks, 3 steps", sd, vae, encoders,
        vism_args(str(root), offload_blocks=True), dev, 3, fp8=True)
    per_step = {k: v / 3 for k, v in launches.items()
                if not k.startswith(("rownorm", K6))}
    # three attentions a block: the forward walk and the recompute launch
    # K1, the backward K2 and K3 (240, 120, 120 at 40 layers)
    n_att = 3 * sd.cfg.num_layers
    want = {"flash_attention": 2 * n_att, "flash_attention_bwd_dq": n_att,
            "flash_attention_bwd_dkv": n_att}
    if per_step != want:
        raise AssertionError(f"14b ViSM step launches {per_step}, expected "
                             f"{want}")
    del lora
    gc.collect()
    torch.cuda.empty_cache()

    # the same step streamed and with the blocks resident, for the overlap
    tcfg = VismTrainConfig()
    sample = next(vism_samples(dev, 1))
    batch = prepare_vism_batch(sample, vae, encoders.encode_text,
                               encoders.encode_clip)
    with torch.device("meta"):
        shapes = WanDiT(sd.cfg).state_dict()

    def timed_steps(trainer, n=2):
        """(warm step seconds, peak GiB, each step's (loss, grad norm,
        factors after the update))."""
        lora = create_lora(shapes, torch.Generator(dev).manual_seed(3),
                           rank=4, alpha=4.0)
        opt, _ = make_adamw(factor_leaves(lora), 1e-4)
        update = GradUpdate(factor_leaves(lora), opt)
        g = torch.Generator(dev).manual_seed(4)
        secs, trace = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n + 1):
            idx, noise = draw(tcfg, batch, g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.train_step(lora, update, batch, idx, noise)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            trace.append((m["loss"], m["grad_norm"],
                          [p.detach().clone() for p in factor_leaves(lora)]))
        return secs[1:], torch.cuda.max_memory_allocated() / 2 ** 30, trace

    streamed = StreamedLoRATrainer(sd.model, sd.host_blocks, tcfg, 4, 4.0,
                                   device=dev, rope_tables=sd.rope_tables)
    s_streamed, peak_streamed, trace_streamed = timed_steps(streamed)
    copy_ms = 2 * cuda_ms(streamed.copy_blocks, 2)
    lora = create_lora(shapes, torch.Generator(dev).manual_seed(3), rank=4,
                       alpha=4.0)
    opt, _ = make_adamw(factor_leaves(lora), 1e-4)
    update = GradUpdate(factor_leaves(lora), opt)
    g = torch.Generator(dev).manual_seed(4)

    def streamed_step():
        idx, noise = draw(tcfg, batch, g)
        streamed.train_step(lora, update, batch, idx, noise)

    profile = profile_phase({"vism step 14b streamed": streamed_step})
    del lora, opt, update
    resident = resident_blocks_trainer(streamed)
    del streamed
    s_resident, peak_resident, trace_resident = timed_steps(resident)
    del resident
    gc.collect()
    torch.cuda.empty_cache()
    # every slot took 20 blocks in turn: a copy into a buffer before its
    # block's backward ran would change the gradients here
    same_bits = all(
        a[0] == b[0] and a[1] == b[1]
        and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))
        for a, b in zip(trace_streamed, trace_resident))
    factor_diff = max((x - y).abs().max().item()
                      for a, b in zip(trace_streamed, trace_resident)
                      for x, y in zip(a[2], b[2]))
    log(f"14b ViSM, {sd.cfg.num_layers} blocks, 3 AdamW steps: streamed "
        f"losses {[a[0] for a in trace_streamed]}, grad norms "
        f"{[a[1] for a in trace_streamed]}; blocks resident losses "
        f"{[b[0] for b in trace_resident]}, grad norms "
        f"{[b[1] for b in trace_resident]}; max factor difference "
        f"{factor_diff:.3e}; the same bits: {same_bits}")
    if not same_bits:
        raise AssertionError("14b ViSM: the streamed step differs from the "
                             "same step with the blocks resident")
    del trace_streamed, trace_resident
    ts, tr = float(np.median(s_streamed)), float(np.median(s_resident))
    overlap = 1.0 - (ts - tr) / (copy_ms / 1e3)
    tokens = ((FRAMES - 1) // 4 + 1) * (H // 16) * (W // 16)
    log(f"14b ViSM step, 1 x {tokens} tokens: streamed {ts:.3f} s (runs "
        f"{[round(v, 3) for v in s_streamed]}, peak {peak_streamed:.2f} "
        f"GiB), blocks resident in fp8 {tr:.3f} s (runs "
        f"{[round(v, 3) for v in s_resident]}, peak {peak_resident:.2f} "
        f"GiB); the {2 * sd.cfg.num_layers} block copies alone (forward and "
        f"backward walk) "
        f"{copy_ms:.1f} ms; overlap share {overlap:.3f}; {pinned / 1e9:.2f} "
        f"GB pinned; on {smi}")

    # streamed against the resident LoRA step at reduced depth
    n = VISM14B_CHECK_LAYERS
    cfg_n = dataclasses.replace(sd.cfg, num_layers=n)
    sd_n = {**{k: v for k, v in sd.model.state_dict().items()},
            **{f"blocks.{i}.{k}": v.to(dev)
               for i in range(n)
               for k, v in sd.host_blocks[i].tensors.items()}}
    res_n = from_state_dict(lambda: WanDiT(cfg_n), sd_n, torch.bfloat16)
    res_n.requires_grad_(False)
    g = torch.Generator(dev).manual_seed(5)
    lora = create_lora(res_n.state_dict(), g, rank=4, alpha=4.0)
    with torch.no_grad():
        for f in lora["factors"].values():
            f["up"].normal_(0.0, 0.01, generator=g)
    idx, noise = draw(tcfg, batch, g)
    leaves = factor_leaves(lora)
    results = {}
    for label, host in (("streamed", False), ("streamed acts_on_host",
                                              True)):
        tr_n = StreamedLoRATrainer(sd.model, sd.host_blocks[:n], tcfg, 4,
                                   4.0, device=dev,
                                   rope_tables=sd.rope_tables,
                                   acts_on_host=host)
        loss = tr_n.loss_and_grads(lora, batch, idx, noise)
        results[label] = (loss, [p.grad.clone() for p in leaves])
        for p in leaves:
            p.grad = None
        del tr_n
    results["resident"] = loss_and_grads(res_n, tcfg, lora, batch, idx,
                                         noise)
    (ls, gs), (lh, gh), (lr, grs) = (results[k] for k in (
        "streamed", "streamed acts_on_host", "resident"))
    rel = (sum((a - b).float().square().sum() for a, b in zip(gs, grs))
           .sqrt() / sum(b.float().square().sum() for b in grs).sqrt()
           ).item()
    same_host = lh == ls and all(torch.equal(a, b) for a, b in zip(gs, gh))
    log(f"14b ViSM, {n} full-width blocks at {FRAMES}f {H}x{W}: streamed loss "
        f"{ls:.6f}, resident (bf16 merged weights) {lr:.6f}; factor "
        f"gradients relative error {rel:.3e} (tol {VISM14B_REL_TOL}); "
        f"acts_on_host gives the same bits: {same_host}")
    if not (rel < VISM14B_REL_TOL and abs(ls - lr) <= VISM14B_REL_TOL
            * abs(lr) and same_host):
        raise AssertionError(f"14b ViSM streamed step disagrees: rel "
                             f"{rel:.3e}, loss {ls} vs {lr}, acts_on_host "
                             f"same {same_host}")
    stats = dict(run, pinned_gb=pinned / 1e9, step_streamed_s=ts,
                 step_resident_fp8_s=tr, step_streamed_all_s=s_streamed,
                 step_resident_fp8_all_s=s_resident, block_copies_ms=copy_ms,
                 overlap_share=overlap, peak_streamed_step_gib=peak_streamed,
                 streamed_equals_resident_blocks=same_bits,
                 peak_resident_step_gib=peak_resident,
                 vs_resident_rel_err=rel, loss_streamed=ls, loss_resident=lr,
                 launches_per_step=per_step, profile=profile)
    del res_n, lora, batch, sample, encoders, results, gs, gh, grs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stats


VAE_TRAIN_STEPS = 3


def vae_train_phase(dev):
    """The adaptor CLI's ``run_training`` at its defaults (17 frames of
    384x512, the VAE in fp32 with its decoder fine-tuned, both adaptors,
    AdamW, the outlier skip) for VAE_TRAIN_STEPS steps on normalised
    synthetic trajectories from a seed: losses finite, the adaptors and
    the decoder move; the step time and peak memory logged."""
    import gc

    import torch

    from more4d_tpu_torch.config import VAEConfig
    from more4d_tpu_torch.kernels import _build
    from more4d_tpu_torch.models import (VAEDecoderAdaptor,
                                         VAEEncoderAdaptor, WanVAE)
    from more4d_tpu_torch.scripts.train_vae import build_parser, run_training

    out = str(_build.BUILD / "chip_smoke_vae")
    shutil.rmtree(out, ignore_errors=True)
    args = build_parser().parse_args(
        ["--video_list", "-", "--vae_ckpt", "-", "--output_dir", out,
         "--max_steps", str(VAE_TRAIN_STEPS), "--log_steps", "1",
         "--checkpointing_steps", "1000"])
    gen = torch.Generator(dev).manual_seed(8)
    with torch.device(dev):
        vae = WanVAE(VAEConfig()).init_weights(gen)
        torch.manual_seed(8)
        enc, dec = VAEEncoderAdaptor(), VAEDecoderAdaptor()
    watch = {"enc": enc.conv_in.weight, "dec": dec.conv_out.weight,
             "vae_decoder": vae.decoder.head[2].weight}
    before = {k: v.detach().clone() for k, v in watch.items()}
    rs = np.random.RandomState(8)
    t, h, w = args.num_frames, args.height, args.width
    flows = [np.clip(0.3 * rs.randn(1, h, w, 3) + 0.02 * np.arange(t)[
        :, None, None, None] * rs.randn(1, h, w, 3), -1, 1).astype(
        np.float32) for _ in range(VAE_TRAIN_STEPS)]
    timings = []
    torch.cuda.reset_peak_memory_stats()
    run_training(vae, enc, dec, iter(flows), args, device=dev,
                 timings=timings)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = [r for r in _metrics(out) if "train/nll_loss" in r]
    losses = [r["train/loss"] for r in records]
    moved = {k: (v - before[k]).abs().max().item() for k, v in watch.items()}
    log(f"vae adaptor training, {t} frames of {h}x{w}: losses {losses}, "
        f"steps {[round(v, 3) for v in timings]} s, peak {peak:.2f} GiB, "
        f"max |change| {moved}")
    if len(losses) != VAE_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"vae adaptor losses {losses}")
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"vae adaptor training moved nothing: {moved}")
    stats = dict(losses=losses, step_s=timings,
                 warm_step_s=float(np.mean(timings[1:])), peak_gib=peak)
    del vae, enc, dec
    gc.collect()
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------------ driver

# ---------------------------------------------------------------- the mesh

PAR_WORLD = 2
# each of the two ranks on the one card holds at most this share of it,
# in expandable segments: a rank that finds the card full has cuDNN fall
# back to another plan for the adaptor's convolutions (a caught
# out-of-memory error), which moves its clouds by ~2e-4 and a render's
# pixels by whole colours; capped, both ranks run the one-process run's
# plans (tools/replica_witness.py). The first plan needs ~33 GiB at the
# rank's peak; the three processes' contexts take ~2 GiB of the card's
# 79.2 (at 0.48 in fixed segments, and at 0.45, a rank still caught
# errors on the H100)
PAR_MEM_FRACTION = 0.47
PAR_STRAAG_STEPS = 2
# the STraG mesh runs (label, --mesh, layers, global batch, more flags):
# the AdamW fsdp=2 run (and the NCCL one) at all 30 of the 1.3B's layers;
# data=2 holds the whole fp32 state on each of the two ranks, and 30
# layers twice do not fit the one card, so it runs 15; the CAME fsdp=2
# run (its factored moments and RMS clip on the shards) takes 15 for the
# script's time
PAR_STRAAG_CASES = [("straag_fsdp", "fsdp=2", 30, 1, ()),
                    ("straag_data2", "data=2", 15, 2, ()),
                    ("straag_came_fsdp", "fsdp=2", 15, 1,
                     ("--optimizer", "came", "--lr_scheduler", "constant",
                      "--learning_rate", "1e-4", "--max_steps", "1"))]
# the tensors each STraG run hands back after its steps, held to the
# one-device run's: the modulation tables (dim 0 of size 1, cut unevenly
# over the fsdp ranks), a matrix cut by JAX's rule and one FSDP2 cuts on
# dim 0. At the CLI's default warm-up the first update is 0 (lr 0 at
# step 0), so the CAME case runs at a constant 1e-4: its one step's
# gradients are the one device's bits, and these tensors carry CAME's
# update of them. (A second step would read those tensors through the
# bf16 forward, where a last-bit difference in a weight flips roundings
# and CAME's step, which divides each gradient by its own RMS, carries
# that into every element, as far as one process on 1 and on 3 threads
# parts on the CPU)
PAR_WATCH = ("blocks.0.modulation", "head.modulation",
             "blocks.0.self_attn.q.weight", "blocks.0.norm3.weight")
PAR_TRAJ = [("static", {}), ("circle_rotating", {})]
PAR_JOIN_S = 600           # the ranks' time limit, then they are ended
PAR_STEP_REL_TOL = 1e-2    # bf16: a few ulps where cuBLAS tiles M anew
# run_two_stage end to end against the one-process run: every rank
# renders rank 0's clouds, and the split DiT gives the one-process bits
PAR_VIDEO_REL_TOL = 1e-2
PAR_SWEEP_TOL = 1e-2       # stage 2 a trajectory a rank, the serial shapes
PAR_FSDP_REL_TOL = 1e-5    # the same rows and shapes on each rank
# a row a rank against a batch of 2 in bf16: 1.07e-5 sound on the H100;
# the gradients summed over the ranks, not averaged, read far above (the
# planted run, checked each time)
PAR_DATA2_REL_TOL = 1e-4
# K1 at the shapes a rank gives it under the mesh: Ulysses' H/S heads over
# the whole sequence (1.3B at S=2, 14B at S=4), and the cross-attentions'
# L/S queries
K1_RANK_CASES = [("sp2_self", 2, 9568, 9568, [9568, 9568], 6),
                 ("sp4_self_14b", 2, 9568, 9568, [9568, 9568], 10),
                 ("sp2_cross_text", 2, 4784, 512, None, 12),
                 ("sp2_cross_clip", 2, 4784, 257, None, 12),
                 ("sp4_cross_text_14b", 2, 2392, 512, None, 40),
                 ("sp4_cross_clip_14b", 2, 2392, 257, None, 40)]


def stand_in_conditioning(dev):
    """Encoder outputs from fixed seeds with the 1.3B towers' shapes (umT5
    [n, 512, 4096], CLIP [n, 257, 1280], OmniMAE [n, 196, 768], bf16): the
    mesh phase drives the DiTs, not the towers."""
    import torch

    from more4d_tpu_torch.infer import ConditioningEncoders

    def seeded(shape, seed):
        g = torch.Generator(dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    return ConditioningEncoders(
        encode_text=lambda ps: torch.cat([seeded((1, 512, 4096), len(p))
                                          for p in ps]),
        encode_clip=lambda im: seeded((1, 257, 1280), 1000).repeat(
            im.shape[0], 1, 1),
        extract_mpm=lambda im: seeded((1, 196, 768), 1001).repeat(
            im.shape[0], 1, 1))


def mesh_inference(dev, mesh=None):
    """The 1.3B two-stage models from seed 0 on the stand-in conditioning
    and, with ``mesh``, both DiTs sharded and (seq > 1) the seq mesh
    installed, as ``infer --sp``/``--fsdp`` do: (models, the CFG-doubled
    DiT step's closure, run_two_stage's keyword arguments)."""
    import torch

    from more4d_tpu_torch.config import PipelineConfig
    from more4d_tpu_torch.infer import build_two_stage_models
    from more4d_tpu_torch.parallel import set_mesh, shard_params
    from more4d_tpu_torch.parallel.mesh import mesh_shape

    pcfg = PipelineConfig(num_inference_steps=STEPS, num_frames=FRAMES,
                          height=H, width=W)
    torch.manual_seed(0)        # the decoder adaptor's default init
    m = build_two_stage_models(stand_in_conditioning(dev), pcfg, seed=0,
                               device=dev)
    gen = torch.Generator(dev).manual_seed(7)
    for pipe in (m.control_pipeline, m.inpaint_pipeline):
        _draw_zero_init(pipe.dit, gen)
    if mesh is not None:
        for pipe in (m.control_pipeline, m.inpaint_pipeline):
            shard_params(pipe.dit, mesh)
        if mesh_shape(mesh)["seq"] > 1:
            set_mesh(mesh)
    rs = np.random.RandomState(0)
    kw = dict(image01=rs.rand(H, W, 3).astype(np.float32), prompt=PROMPT,
              depth=(1.0 + 5.0 * rs.rand(H, W)).astype(np.float32),
              trajectory_types=PAR_TRAJ)
    return m, dit_step(m, dev), kw


def straag_synthetic_batches():
    """``StraagTrainer.prepare_batch`` replaced by prepared batches made
    from seeds on the card (the latents, 48-channel conditioning, umT5,
    CLIP and OmniMAE shapes of the 1.3B at 49 x 368 x 512): row i of step
    s from seed 100 s + i, so that a rank's rows of a global batch are the
    rows the one-process run takes."""
    import torch

    from more4d_tpu_torch.train import harness

    lat = ((FRAMES - 1) // 4 + 1, H // 8, W // 8)
    shapes = {"latents": lat + (16,), "y": lat + (48,),
              "context": (512, 4096), "clip_fea": (257, 1280),
              "mpm_features": (196, 768)}

    def prepare(self, samples, prompts):
        rows = range(len(samples))[self._rows(len(samples))]
        out = {}
        for name, shape in shapes.items():
            parts = []
            for i in rows:
                g = torch.Generator(self.device).manual_seed(
                    100 * self.global_step + i)
                parts.append(torch.randn((1,) + shape, generator=g,
                                         device=self.device))
            out[name] = torch.cat(parts)
        return out

    return _patched(harness.StraagTrainer, "prepare_batch", prepare)


@contextlib.contextmanager
def _patched(owner, name, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, real)


def mesh_straag(dev, mesh_spec, layers, batch, out_dir, planted=False,
                flags=()):
    """``train_straag``'s ``run_training`` at the 1.3B width (``layers``
    deep) for PAR_STRAAG_STEPS steps of a global ``batch`` on the
    synthetic prepared batches, ``--no-uniform_sampling`` (so every run
    draws the same timesteps and noise from the seed), under
    ``--mesh mesh_spec`` (None: the one-device path): each step's loss and
    grad norm, the launches, the wall and this process's peak memory.
    ``planted``: a wrong reduction, the gradients summed over the data
    ranks where they are averaged (FSDP2's divide factor set to 1).
    ``flags``: more of the CLI's flags (``--optimizer came``)."""
    import dataclasses

    import torch

    from torch.distributed.fsdp import FSDPModule

    from more4d_tpu_torch.parallel import mesh as mesh_mod

    from more4d_tpu_torch.models import VAEEncoderAdaptor, WanVAE
    from more4d_tpu_torch.config import VAEConfig
    from more4d_tpu_torch.infer import ConditioningEncoders
    from more4d_tpu_torch.scripts.train_straag import run_training

    dit = build_straag_dit(dev, seed=0)
    if layers < len(dit.blocks):
        dit.blocks = dit.blocks[:layers]
        dit.cfg = dataclasses.replace(dit.cfg, num_layers=layers)
    extra = ["--no-uniform_sampling", "--max_steps", str(PAR_STRAAG_STEPS),
             "--batch_size", str(batch), *flags]
    if mesh_spec:
        extra += ["--mesh", mesh_spec]
    args = straag_args(out_dir, *extra)
    # prepare_batch is replaced: a small frozen VAE and adaptor suffice
    vae = WanVAE(VAEConfig(dim=8, z_dim=16, num_res_blocks=1))
    none = ConditioningEncoders(encode_text=None)
    samples = [([None] * batch, [""] * batch)] * PAR_STRAAG_STEPS
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    shard = mesh_mod.shard_params

    def summed(module, mesh, *a, **k):
        shard(module, mesh, *a, **k)
        for unit in module.modules():
            if isinstance(unit, FSDPModule):
                unit.set_gradient_divide_factor(1.0)
        return module

    with straag_instrumented(), straag_synthetic_batches(), \
            _patched(mesh_mod, "shard_params",
                     summed if planted else shard):
        trainer, launches = _run_counted(lambda: run_training(
            dit, vae, VAEEncoderAdaptor(), none, iter(samples), args,
            device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = dict(launches=launches, wall_s=wall, layers=layers, batch=batch,
               mesh=mesh_spec,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    own = dict(trainer.dit.named_parameters())
    watched = {n: _whole_on_host(own[n]) for n in PAR_WATCH}
    if trainer.mesh is None or trainer.mesh.get_rank() == 0:
        records = [r for r in _metrics(out_dir) if "train/loss" in r]
        out.update(losses=[r["train/loss"] for r in records],
                   grad_norms=[r["train/grad_norm"] for r in records],
                   params=watched)
    del trainer, dit
    return out


def _whole_on_host(p):
    """A parameter whole, in fp32 on the host: a DTensor's shards gathered
    as host objects over its shard group, in rank order. (``full_tensor``
    redistributes through functional collectives, which killed both gloo
    ranks holding CUDA tensors on an H100 80GB HBM3.)"""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return p.detach().float().cpu()
    local = p.to_local().detach().float().cpu()
    for i, pl in enumerate(p.placements):
        if pl.is_shard():
            group = p.device_mesh.get_group(i)
            parts = [None] * dist.get_world_size(group)
            dist.all_gather_object(parts, local, group=group)
            return torch.cat(parts, dim=pl.dim)
    return local


def _counted_step(step):
    """The DiT step's output and K1's launches, then its wall."""
    import torch

    out, launches = _run_counted(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return dict(out=out.float().cpu(),
                launches={k: launches[k] for k in ("flash_attention",
                                                   "rownorm", K6, K6_WANT)},
                wall_s=time.perf_counter() - t0)


def _clouds_digest(coords):
    import hashlib

    return hashlib.sha1(coords.float().cpu().numpy().tobytes()).hexdigest()


def _mesh_two_stage(m, kw, ref, **extra):
    """``run_two_stage`` on this rank, counted and timed: its videos, its
    clouds against the one-process run's and their digest."""
    import torch

    from more4d_tpu_torch.infer import run_two_stage
    from more4d_tpu_torch.kernels.gs_splat import splat_cuda

    splat_cuda.launches = 0
    t0 = time.perf_counter()
    run, launches = _run_counted(lambda: run_two_stage(
        m, kw["image01"], kw["prompt"], depth=kw["depth"],
        trajectory_types=kw["trajectory_types"], **extra))
    torch.cuda.synchronize()
    return dict(videos=[v["video"].float().cpu() for v in run["videos"]],
                coords_err=rel_err(run["coords"].cpu(), ref["coords"]),
                coords_digest=_clouds_digest(run["coords"]),
                launches={"flash_attention": launches["flash_attention"],
                          "gs_splat": splat_cuda.launches,
                          "rownorm": launches["rownorm"],
                          K6: launches[K6], K6_WANT: launches[K6_WANT]},
                wall_s=time.perf_counter() - t0)


def reference_rank(rank, world, init, out_dir, device_type):
    """The one-process references, in a fresh process with the card to
    itself and no process group: a process that ran other phases may keep
    cuDNN plans it picked while its card was full (a plan is picked once
    per shape; tools/replica_witness.py shows the fallbacks' other bits).
    The CFG-doubled DiT step, ``run_two_stage``'s videos, clouds and
    renders, and the STraG runs at each PAR_STRAAG_CASES depth and batch
    with no mesh; written to ``out_dir``."""
    import gc
    import os

    import torch

    from more4d_tpu_torch.infer import run_two_stage

    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    m, step, kw = mesh_inference(dev)
    with torch.no_grad():
        ref = dict(step=step().float().cpu())
    run = run_two_stage(m, kw["image01"], kw["prompt"], depth=kw["depth"],
                        trajectory_types=kw["trajectory_types"])
    ref.update(videos=[v["video"].float().cpu() for v in run["videos"]],
               coords_digest=_clouds_digest(run["coords"]),
               coords=run["coords"].cpu(), renders=[
                   {k: v.cpu() if torch.is_tensor(v) else v
                    for k, v in r.items()} for r in run["renders"]])
    del m, step, run
    gc.collect()
    torch.cuda.empty_cache()
    ref["straag"] = {}
    for label, _, layers, batch, flags in PAR_STRAAG_CASES:
        ref["straag"][label] = mesh_straag(
            dev, None, layers, batch, os.path.join(out_dir, label),
            flags=flags)
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(ref, os.path.join(out_dir, f"rank{rank}.pt"))


def parallel_rank(rank, world, init, out_dir, device_type):
    """One of the two ranks that share the card: gloo (NCCL refuses two
    ranks on one device), at most PAR_MEM_FRACTION of the card each. The
    paths ``sp_dit_step``, ``sp_run_two_stage`` (``infer --sp 2``),
    ``sweep_dp`` (``run_two_stage(sweep_mesh=)``), ``stage2_dp``
    (``stage2_inpaint_dp`` on the one-process run's renders, from
    ``reference.pt`` beside ``out_dir``), ``fsdp_dit_step``,
    ``fsdp_run_two_stage`` (``infer --fsdp``: both DiTs over fsdp=2),
    then the PAR_STRAAG_CASES and the planted ``straag_data2`` with its
    gradients summed, each counted from zero; writes its results to
    ``out_dir``."""
    import datetime
    import gc
    import os

    import torch
    import torch.distributed as dist

    from more4d_tpu_torch.infer import stage2_inpaint_dp
    from more4d_tpu_torch.parallel import MeshConfig, create_mesh, set_mesh

    # before the allocator's first use in this process
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.set_per_process_memory_fraction(PAR_MEM_FRACTION)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_JOIN_S))
    res = {}
    ref = torch.load(os.path.join(os.path.dirname(out_dir), "reference.pt"))

    def drop():
        gc.collect()
        torch.cuda.empty_cache()

    ooms = [0]

    def keep(path, result):
        """``result`` with the path's caught out-of-memory errors, peak
        and what the allocator holds after it."""
        n = torch.cuda.memory_stats().get("num_ooms", 0)
        result["memory"] = dict(
            num_ooms=n - ooms[0],
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            reserved_gib=torch.cuda.memory_reserved() / 2 ** 30)
        ooms[0] = n
        torch.cuda.reset_peak_memory_stats()
        res[path] = result

    try:
        sp = create_mesh(MeshConfig(data=1, fsdp=-1, seq=world),
                         device=dev, backend="gloo")
        m, step, kw = mesh_inference(dev, sp)
        keep("sp_dit_step", _counted_step(step))
        keep("sp_run_two_stage", _mesh_two_stage(m, kw, ref))
        set_mesh(None)
        dp = create_mesh(MeshConfig(data=world, fsdp=1), device=dev,
                         backend="gloo")
        keep("sweep_dp", _mesh_two_stage(m, kw, ref, sweep_mesh=dp))
        t0 = time.perf_counter()
        videos, launches = _run_counted(lambda: stage2_inpaint_dp(
            m, [{k: v.to(dev) if torch.is_tensor(v) else v
                 for k, v in r.items()} for r in ref["renders"]],
            kw["prompt"], generator=torch.Generator(dev).manual_seed(1),
            mesh=dp, shared_noise=True))
        torch.cuda.synchronize()
        keep("stage2_dp", dict(
            videos=list(videos.float().cpu()),
            launches={k: launches[k] for k in ("flash_attention",
                                               "rownorm", K6, K6_WANT)},
            wall_s=time.perf_counter() - t0))
        del m, step, videos
        drop()
        fs = create_mesh(MeshConfig(data=1, fsdp=world, seq=1), device=dev,
                         backend="gloo")
        m, step, kw = mesh_inference(dev, fs)
        keep("fsdp_dit_step", _counted_step(step))
        keep("fsdp_run_two_stage", _mesh_two_stage(m, kw, ref))
        del m, step
        drop()
        # a directory a rank: mesh_straag clears it first
        for label, spec, layers, batch, flags in PAR_STRAAG_CASES:
            res[label] = mesh_straag(dev, spec, layers, batch,
                                     os.path.join(out_dir, f"{label}{rank}"),
                                     flags=flags)
            drop()
        res["straag_data2_summed"] = mesh_straag(
            dev, "data=2", 15, 2, os.path.join(out_dir, f"planted{rank}"),
            planted=True)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def nccl_rank(rank, world, init, out_dir, device_type):
    """One rank on NCCL, the production backend: ``train_straag --mesh
    fsdp=-1`` at the depth of the ``straag_fsdp`` case for
    PAR_STRAAG_STEPS steps (gloo on the CPU)."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_JOIN_S))
    try:
        layers = dict((c[0], c[2]) for c in PAR_STRAAG_CASES)["straag_fsdp"]
        res = mesh_straag(dev, "fsdp=-1", layers, 1,
                          os.path.join(out_dir, "straag_nccl"))
        torch.save({"straag_nccl": res},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world, root, dev):
    """``target(rank, world, init, out_dir, dev.type)`` in ``world`` spawned
    processes on a ``file://`` store under ``root``: each rank's results,
    in rank order. Fails when a rank fails or has not ended after
    PAR_JOIN_S seconds (then every rank is ended)."""
    import os

    import torch
    import torch.multiprocessing as mp

    out_dir = os.path.join(root, target.__name__)
    os.makedirs(out_dir, exist_ok=True)
    init = "file://" + os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, init, out_dir, dev.type))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_JOIN_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if alive or any(codes):
        raise AssertionError(f"{target.__name__}: ranks {alive} still "
                             f"running after {PAR_JOIN_S} s, exit codes "
                             f"{codes}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def rel_err(got, want):
    """(max |got - want|, |got - want| / |want| in the 2-norm)."""
    d = got.float() - want.float()
    return d.abs().max().item(), (d.norm() / want.float().norm()).item()


def parallel_phase(dev, smi):
    """The device mesh (``parallel/mesh.py``, ``ulysses.py``) on one card.

    1. K1 against its plain version at the shapes a rank gives it under
       the mesh (K1_RANK_CASES), with the K1 phase's tolerances;
    2. references in a fresh process of their own (``reference_rank``),
       no process group: the CFG-doubled 1.3B DiT step and
       ``run_two_stage`` (the serial sweep) on seeded weights and
       conditioning; ``run_training`` of the STraG CLI on synthetic
       prepared batches at each PAR_STRAAG_CASES depth and batch;
    3. two ranks sharing the card on gloo (``parallel_rank``): the same
       step and ``run_two_stage`` under ``--sp 2`` and under ``--fsdp``
       (fsdp=2), the data-parallel sweep (``run_two_stage(sweep_mesh=)``,
       a trajectory a rank, and ``stage2_inpaint_dp`` on the reference's
       renders), the STraG runs under ``--mesh fsdp=2`` (AdamW, and
       ``--optimizer came``) and ``--mesh data=2``, each held to its
       reference, and a data=2 run with its gradients summed over the
       ranks, which the check must reject;
    4. one rank on NCCL (``nccl_rank``): ``--mesh fsdp=-1`` at the
       ``straag_fsdp`` case's depth, against the one-device run.
    Two ranks on one card show the mesh's arithmetic, not its speed: their
    walls are logged as walls. Returns ({path: launches}, stats)."""
    import tempfile

    import torch

    stats = {"k1": {}}
    gen = torch.Generator(dev).manual_seed(10)
    for name, b, lq, lk, lens, h in K1_RANK_CASES:
        stats["k1"][name] = k1_case(dev, gen, name, b, lq, lk, lens, h)

    paths = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        one = spawn_ranks(reference_rank, 1, root, dev)[0]
        stats["reference_wall_s"] = time.perf_counter() - t0
        ref_step, ref_videos = one["step"], one["videos"]
        ref_digest, ref = one["coords_digest"], one["straag"]
        torch.save(dict(coords=one["coords"], renders=one["renders"]),
                   f"{root}/reference.pt")
        del one
        log(f"parallel: {PAR_WORLD} ranks share the one card, so their "
            f"process group is gloo (create_mesh(backend='gloo')): NCCL "
            f"refuses two ranks on one device; NCCL runs on one rank "
            f"below. Each rank holds at most {PAR_MEM_FRACTION} of the "
            f"card (this process {torch.cuda.memory_reserved() / 2**30:.2f}"
            f" GiB). Their walls are not the mesh's speed.")
        t0 = time.perf_counter()
        ranks = spawn_ranks(parallel_rank, PAR_WORLD, root, dev)
        stats["ranks_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = spawn_ranks(nccl_rank, 1, root, dev)[0]["straag_nccl"]
        stats["nccl_wall_s"] = time.perf_counter() - t0

    inference = ("sp_dit_step", "sp_run_two_stage", "sweep_dp", "stage2_dp",
                 "fsdp_dit_step", "fsdp_run_two_stage")
    for r, res in enumerate(ranks):
        # a caught out-of-memory error lets cuDNN run another plan: logged
        log(f"parallel: rank {r}'s memory by path (caught out-of-memory "
            f"errors, peak and held GiB): "
            + "; ".join(f"{p} {res[p]['memory']['num_ooms']}, "
                        f"{res[p]['memory']['peak_gib']:.2f}, "
                        f"{res[p]['memory']['reserved_gib']:.2f}"
                        for p in inference))
        # each rank holds the whole output: the one-process bits or a few
        # bf16 ulps
        for path in ("sp_dit_step", "fsdp_dit_step"):
            err, rel = rel_err(res[path]["out"], ref_step)
            log(f"parallel: {path}, rank {r}: max|out - one process| "
                f"{err:.3e}, relative {rel:.3e} (tol {PAR_STEP_REL_TOL}), "
                f"max|out| {ref_step.abs().max().item():.3e}, bf16 ulp "
                f"there {bf16_ulp(ref_step.abs().max().item()):.3e}; wall "
                f"{res[path]['wall_s']:.3f} s (two ranks on one card)")
            stats.setdefault(path, []).append(dict(
                max_abs_err=err, rel_err=rel, wall_s=res[path]["wall_s"]))
            if not rel <= PAR_STEP_REL_TOL:
                raise AssertionError(f"{path}, rank {r}: relative error "
                                     f"{rel:.3e}")
        for path, tol in (("sp_run_two_stage", PAR_VIDEO_REL_TOL),
                          ("fsdp_run_two_stage", PAR_VIDEO_REL_TOL),
                          ("sweep_dp", PAR_VIDEO_REL_TOL),
                          ("stage2_dp", PAR_SWEEP_TOL)):
            errs = [rel_err(g, w) for g, w in zip(res[path]["videos"],
                                                   ref_videos)]
            clouds = res[path].get("coords_err")
            log(f"parallel: {path}, rank {r}: videos against the one-process "
                f"serial sweep (max abs, relative) "
                f"{[(f'{e:.3e}', f'{q:.3e}') for e, q in errs]}"
                + ("" if clouds is None else
                   f"; stage-1 clouds (max abs, relative) {clouds[0]:.3e}, "
                   f"{clouds[1]:.3e}")
                + f"; wall {res[path]['wall_s']:.2f} s; launches "
                f"{res[path]['launches']}")
            stats.setdefault(path, []).append(dict(
                errors=errs, clouds_err=clouds, wall_s=res[path]["wall_s"]))
            worst = max(e if path == "stage2_dp" else q for e, q in errs)
            if len(errs) != len(PAR_TRAJ) or not worst <= tol:
                raise AssertionError(f"{path}, rank {r}: videos {errs}")
            if not all(torch.isfinite(v).all() and v.min() >= 0
                       and v.max() <= 1 for v in res[path]["videos"]):
                raise AssertionError(f"{path}, rank {r}: videos not finite "
                                     f"in [0, 1]")
        # the ranks whose work joins render one cloud: rank 0's
        for path in ("sp_run_two_stage", "sweep_dp"):
            if res[path]["coords_digest"] != ranks[0][path]["coords_digest"]:
                raise AssertionError(f"{path}: rank {r} rendered other "
                                     f"clouds than rank 0")
    stats["clouds_as_one_process"] = {
        path: [r[path]["coords_digest"] == ref_digest for r in ranks]
        for path in ("sp_run_two_stage", "fsdp_run_two_stage", "sweep_dp")}

    def straag_rel(got, want):
        return [abs(g / w - 1) for g, w in
                zip(got["losses"] + got["grad_norms"],
                    want["losses"] + want["grad_norms"])]

    for path, spec, _, _, _ in PAR_STRAAG_CASES:
        got, want = ranks[0][path], ref[path]
        tol = PAR_FSDP_REL_TOL if spec.startswith("fsdp") else \
            PAR_DATA2_REL_TOL
        rel = straag_rel(got, want)
        log(f"parallel: {path} ({got['layers']} layers, global batch "
            f"{got['batch']}): losses {got['losses']} grad norms "
            f"{got['grad_norms']} against one device {want['losses']} "
            f"{want['grad_norms']}: worst relative {max(rel):.3e} (tol "
            f"{tol}); walls {[round(r[path]['wall_s'], 2) for r in ranks]} "
            f"s (one device {want['wall_s']:.2f} s); peaks "
            f"{[round(r[path]['peak_gib'], 2) for r in ranks]} GiB a rank "
            f"(one device {want['peak_gib']:.2f})")
        moved = {n: rel_err(got["params"][n], want["params"][n])[1]
                 for n in PAR_WATCH}
        log(f"parallel: {path}: the watched tensors against one device "
            f"(relative) {moved} (tol {tol})")
        rel = rel + list(moved.values())
        stats[path] = dict(losses=got["losses"], grad_norms=got["grad_norms"],
                           params_rel_err=moved,
                           one_device=dict(losses=want["losses"],
                                           grad_norms=want["grad_norms"],
                                           wall_s=want["wall_s"],
                                           peak_gib=want["peak_gib"]),
                           worst_rel=max(rel), layers=got["layers"],
                           wall_s=[r[path]["wall_s"] for r in ranks],
                           peak_gib=[r[path]["peak_gib"] for r in ranks])
        if not want["losses"] or len(rel) != 2 * len(want["losses"]) \
                + len(PAR_WATCH) or not max(rel) <= tol:
            raise AssertionError(f"{path}: {got} against {want}")
    planted = ranks[0]["straag_data2_summed"]
    rel = straag_rel(planted, ref["straag_data2"])
    log(f"parallel: straag_data2 with its gradients summed over the ranks "
        f"(planted): losses {planted['losses']} grad norms "
        f"{planted['grad_norms']}: worst relative {max(rel):.3e}, which "
        f"the tolerance {PAR_DATA2_REL_TOL} must reject")
    stats["straag_data2_summed"] = dict(worst_rel=max(rel))
    if not max(rel) > PAR_DATA2_REL_TOL:
        raise AssertionError("straag_data2: the check passed a data=2 run "
                             "whose gradients were summed")
    want = ref["straag_fsdp"]
    same = (nccl["losses"] == want["losses"],
            nccl["grad_norms"] == want["grad_norms"])
    rel = straag_rel(nccl, want)
    log(f"parallel: straag_nccl (one rank, NCCL, --mesh fsdp=-1, "
        f"{nccl['layers']} layers): losses {nccl['losses']} grad norms "
        f"{nccl['grad_norms']}; the same bits as one device: losses "
        f"{same[0]}, grad norms {same[1]}; worst relative {max(rel):.3e}; "
        f"wall {nccl['wall_s']:.2f} s (one device {want['wall_s']:.2f}), "
        f"peak {nccl['peak_gib']:.2f} GiB (one device "
        f"{want['peak_gib']:.2f})")
    stats["straag_nccl"] = dict(losses=nccl["losses"],
                                grad_norms=nccl["grad_norms"],
                                same_bits=same, worst_rel=max(rel),
                                layers=nccl["layers"],
                                wall_s=nccl["wall_s"],
                                peak_gib=nccl["peak_gib"])
    if nccl["layers"] != want["layers"] or not max(rel) <= PAR_FSDP_REL_TOL:
        raise AssertionError(f"straag_nccl: {nccl} against {want}")
    stats["inference_memory"] = [{p: r[p]["memory"] for p in inference}
                                 for r in ranks]
    for path in inference + tuple(c[0] for c in PAR_STRAAG_CASES):
        paths[path] = ranks[0][path]["launches"]
    paths["straag_nccl"] = nccl["launches"]
    for path, launches in paths.items():
        for name, n in launches.items():
            if n <= 0 and not name.startswith(("rownorm", K6)):
                raise AssertionError(f"{path}: kernel {name} was not "
                                     f"launched")
        k5_check(path, launches, grad=path.startswith("straag"),
                 epilogues=False)
        k6_check(path, launches, fp8=False)
    log(f"parallel on {smi}: launches {paths}; clouds the one-process "
        f"run's bits {stats['clouds_as_one_process']}")
    return paths, stats


# ---------------------------------------------- the memory modes on a mesh

# the 14B step on two ranks: (path, seq size, memory mode), as the JAX CLI
# runs --fsdp --fp8_weights, --fsdp --offload_blocks and --sp 2
# --offload_blocks
MEM14_MODES = (("fsdp_fp8", 1, "fp8"), ("fsdp_offload", 1, "offload"),
               ("sp2_offload", PAR_WORLD, "offload"))
MEM14_SEED = 140
# what the two ranks pin (~17 GB of fp8 blocks each) and a margin: the
# phase checks that the host has it free first
MEM14_HOST_GIB = 2 * 17 + 8
# infer.main on two ranks at 1.3B, on write_cli_checkpoints' files
MEM_CLI_MODES = {"cli_mesh_fsdp_fp8": ("--fsdp", "--fp8_weights"),
                 "cli_mesh_fsdp_offload": ("--fsdp", "--offload_blocks")}
MEM_CLI_STEPS = 2
MEM_CLI_TRAJECTORIES = "static"


def _draw_zero_init(module, gen):
    """The output head, FiLM projections and gates that init_weights
    zeroes, drawn N(0, 0.02) as a trained checkpoint has them (at zero
    every DiT output is 0 and a comparison holds nothing)."""
    import torch

    with torch.no_grad():
        for name, p in module.named_parameters():
            if (name.startswith("head.head") or name.endswith(".gate")
                    or ".spatial_guide." in name):
                p.normal_(0.0, 0.02, generator=gen)


def resident_14b(cfg, dev, seed):
    """The 14B DiT's resident part (its block list empty) in bf16 on
    ``dev``, random weights from ``seed`` (``WanDiT.init_weights``, the
    zero-initialised ones drawn)."""
    import torch
    from torch import nn

    from more4d_tpu_torch.models import WanDiT

    with torch.device("meta"):
        model = WanDiT(cfg)
    model.blocks = nn.ModuleList()
    model = model.to(torch.bfloat16).to_empty(device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        model.init_weights(gen)
    _draw_zero_init(model, gen)
    return model.eval()


def build_fp8_dit_14b_blockwise(cfg, dev, seed):
    """The 14B DiT as ``--fp8_weights`` holds it, made a block at a time:
    the resident part as ``resident_14b``, then each block drawn in bf16
    (``WanDiT.init_weights``' rules, the zero-initialised tensors drawn)
    and quantized at once (``quantize_params_fp8``, unscaled: the cast is
    elementwise, so a block quantized alone holds the bytes the whole DiT
    quantized does). ~17 GB on the card, never the 34 GB of bf16."""
    import torch
    from torch import nn

    from more4d_tpu_torch.models import WanDiT
    from more4d_tpu_torch.models.wan_dit import WanBlock
    from more4d_tpu_torch.utils.quantize import quantize_params_fp8

    model = resident_14b(cfg, dev, seed)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    holder = nn.Module()
    holder.cfg = cfg
    blocks = []
    for _ in range(cfg.num_layers):
        with torch.device("meta"):
            blk = WanBlock(cfg)
        holder.blocks = nn.ModuleList([blk.to(torch.bfloat16).to_empty(
            device=dev)])
        with torch.no_grad():
            WanDiT.init_weights(holder, gen)
        _draw_zero_init(holder, gen)
        quantize_params_fp8(holder, scaled=False)
        blocks.append(holder.blocks[0])
    model.blocks = nn.ModuleList(blocks)
    return quantize_params_fp8(model, scaled=False).eval()


def _memory():
    """This process's peak and held device memory in GiB since the last
    reset, what its allocator reserves, and its caught out-of-memory
    errors so far."""
    import torch

    return dict(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                held_gib=torch.cuda.memory_allocated() / 2 ** 30,
                reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
                num_ooms=torch.cuda.memory_stats().get("num_ooms", 0))


def _timed_k1(fn):
    """(fn()'s output on the host in fp32, its K1 and K5 launches, its
    wall)."""
    import torch

    from more4d_tpu_torch.kernels.flash_attention import flash_attention_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5 = _zero_counters()["rownorm"]
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return dict(out=out.float().cpu(),
                launches={"flash_attention": flash_attention_cuda.launches,
                          "rownorm": k5.launches, **_k6_counts()},
                wall_s=time.perf_counter() - t0)


def fp8_shards(module):
    """(dtypes of this rank's shards of the fp8 tensors, their bytes,
    the whole tensors' bytes)."""
    from torch.distributed.tensor import DTensor

    from more4d_tpu_torch.utils.quantize import FP8

    fp8 = [p for p in module.parameters() if p.dtype == FP8]
    return (sorted({str(p.to_local().dtype) for p in fp8
                    if isinstance(p, DTensor)}),
            sum(p.to_local().numel() for p in fp8 if isinstance(p, DTensor)),
            sum(p.numel() for p in fp8))


def memory_reference(rank, world, init, out_dir, device_type):
    """The 14B steps the mesh is held to, in a fresh process with the card
    to itself and no process group (``reference_rank``'s pattern): the
    CFG-doubled step of the fp8 DiT and of the streamed one, built from
    the seeds ``memory_14b`` builds them from; their outputs and walls by
    memory mode, written to ``out_dir``."""
    import gc
    import os

    import torch

    from more4d_tpu_torch.parallel import StreamedDiT, make_host_blocks

    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    cfg = dit_14b_configs()["motion"]
    x, t, ctx, kw = dit_step_inputs(cfg, dev)
    model = build_fp8_dit_14b_blockwise(cfg, dev, MEM14_SEED)
    ref = {"fp8": _timed_k1(lambda: model(x, t, ctx, **kw))}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _, host = make_host_blocks(cfg, cfg.num_layers, "fp8", dev,
                               seed=1000 * MEM14_SEED)
    sd = StreamedDiT(resident_14b(cfg, dev, MEM14_SEED + 2), host, dev)
    ref["offload"] = _timed_k1(lambda: sd(x, t, ctx, **kw))
    torch.save({mode: dict(out=r["out"], wall_s=r["wall_s"])
                for mode, r in ref.items()},
               os.path.join(out_dir, f"rank{rank}.pt"))


def memory_14b(dev):
    """On this rank: the CFG-doubled step of the 14B 4D-STraG DiT (40
    layers) in each of MEM14_MODES, from ``memory_reference``'s seeds;
    the outputs, launches, walls and memory by path.

    This drives ``place_dit``'s sharding step (``shard_params``) alone:
    the fp8 DiT is quantized a block at a time as it is drawn, and the
    streamed one's blocks are drawn straight into pinned host buffers,
    since a 14B DiT in bf16 (~34 GB) does not fit a rank's share of the
    card. ``infer.main`` on the mesh (``memory_cli``) drives the whole of
    ``place_dit``."""
    import gc

    import torch

    from more4d_tpu_torch.parallel import (MeshConfig, StreamedDiT,
                                           create_mesh, make_host_blocks,
                                           set_mesh, shard_params)
    from more4d_tpu_torch.parallel.mesh import is_sharded

    cfg = dit_14b_configs()["motion"]
    x, t, ctx, kw = dit_step_inputs(cfg, dev)
    res = {}
    t0 = time.perf_counter()
    model = build_fp8_dit_14b_blockwise(cfg, dev, MEM14_SEED)
    built_s = time.perf_counter() - t0
    whole = fp8_shards(model)[2]
    mesh = create_mesh(MeshConfig(data=1, fsdp=-1, seq=1), device=dev,
                       backend="gloo")
    t0 = time.perf_counter()
    shard_params(model, mesh)
    placed_s = time.perf_counter() - t0
    dtypes, local, total = fp8_shards(model)
    r = _timed_k1(lambda: model(x, t, ctx, **kw))
    r.update(sharded=is_sharded(model), built_s=built_s, placed_s=placed_s,
             fp8_local_dtypes=dtypes, fp8_local_bytes=local,
             fp8_bytes=total, fp8_bytes_before=whole, memory=_memory())
    res["fsdp_fp8"] = r
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, host = make_host_blocks(cfg, cfg.num_layers, "fp8", dev,
                               seed=1000 * MEM14_SEED)
    pinned = sum(hb.flat.numel() for hb in host) / 2 ** 30
    host_s = time.perf_counter() - t0
    for path, seq, mode in MEM14_MODES:
        if mode != "offload":
            continue
        mesh = create_mesh(MeshConfig(data=1, fsdp=-1, seq=seq), device=dev,
                           backend="gloo")
        resident = shard_params(resident_14b(cfg, dev, MEM14_SEED + 2), mesh)
        sd = StreamedDiT(resident, host, dev)
        if seq > 1:
            set_mesh(mesh)
        try:
            r = _timed_k1(lambda: sd(x, t, ctx, **kw))
        finally:
            set_mesh(None)
        r.update(sharded=is_sharded(resident),
                 pinned_gib=pinned, host_blocks_s=host_s,
                 blocks_on_card=len(resident.blocks), memory=_memory())
        res[path] = r
        del sd, resident
        gc.collect()
        torch.cuda.empty_cache()
    del host
    gc.collect()
    release_pinned()
    return res


def memory_cli(dev, spec):
    """On this rank: ``infer.main`` in each of MEM_CLI_MODES on
    ``spec['argv']`` (write_cli_checkpoints' files), counted; whether its
    DiTs came out sharded (and in fp8, or streamed from pinned blocks);
    the clouds rank 0 wrote."""
    import gc
    import os

    import torch
    import torch.distributed as dist

    from more4d_tpu_torch.kernels.gs_splat import splat_cuda
    from more4d_tpu_torch.parallel.mesh import is_sharded
    from more4d_tpu_torch.scripts import infer

    res = {}
    for path, flags in MEM_CLI_MODES.items():
        out = os.path.join(spec["root"], path)
        seen = []
        load = infer.load_models

        def keep(*a, **k):
            seen.append(load(*a, **k))
            return seen[-1]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _patched(infer, "load_models", keep):
            splat_cuda.launches = 0
            rc, launches = _run_counted(lambda: infer.main(
                spec["argv"] + list(flags) + ["--output_dir", out],
                device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipes = (seen[0].control_pipeline, seen[0].inpaint_pipeline)
        dits = [p.dit for p in pipes]
        streamed = [p.streamed_dit for p in pipes]
        r = dict(rc=rc, wall_s=wall, memory=_memory(),
                 launches={"flash_attention": launches["flash_attention"],
                           "gs_splat": splat_cuda.launches,
                           "rownorm": launches["rownorm"]},
                 k6={K6: launches[K6], K6_WANT: launches[K6_WANT]},
                 sharded=all(is_sharded(d) for d in dits),
                 files=sorted(os.listdir(out)) if os.path.isdir(out) else [])
        if "--fp8_weights" in flags:
            for d in dits:
                for m in d.modules():
                    if is_sharded(m):
                        m.reshard()
            shards = [fp8_shards(d) for d in dits]
            r.update(fp8_local_dtypes=sorted({x for s in shards
                                              for x in s[0]}),
                     fp8_local_bytes=sum(s[1] for s in shards),
                     fp8_bytes=sum(s[2] for s in shards))
        else:
            host = [hb for sd in streamed for hb in sd.host_blocks]
            r.update(pinned_gib=sum(hb.flat.numel() for hb in host)
                     / 2 ** 30, pinned=all(hb.flat.is_pinned()
                                           for hb in host),
                     blocks_on_card=sum(len(d.blocks) for d in dits))
        coords = [f for f in r["files"] if f.endswith("_coords.npy")]
        if coords and dist.get_rank() == 0:
            r["coords"] = np.load(os.path.join(out, coords[0]))
        res[path] = r
        del seen, pipes, dits, streamed
        gc.collect()
        torch.cuda.empty_cache()
        release_pinned()
    return res


def memory_rank(rank, world, init, out_dir, device_type):
    """One of the two ranks sharing the card on gloo, at most
    PAR_MEM_FRACTION of it: ``memory_14b``, then ``memory_cli`` on the
    files ``memory.json`` beside ``out_dir`` names; writes its results to
    ``out_dir``."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    from more4d_tpu_torch.parallel import set_mesh

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dev = torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.set_per_process_memory_fraction(PAR_MEM_FRACTION)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=PAR_JOIN_S))
    with open(os.path.join(os.path.dirname(out_dir), "memory.json")) as f:
        spec = json.load(f)
    try:
        res = memory_14b(dev)
        res.update(memory_cli(dev, spec))
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        set_mesh(None)
        dist.destroy_process_group()


def mesh_memory_phase(dev, smi, ck, root):
    """The memory modes on a mesh of two ranks sharing the card on gloo
    (``memory_rank``), each held to PAR_MEM_FRACTION of it:

    1. the 14B 4D-STraG DiT's CFG-doubled step at full width and 40 layers
       from seeds, sharded (``shard_params``, ``place_dit``'s step on a
       mesh) as ``infer --fsdp --fp8_weights``, ``--fsdp --offload_blocks``
       and ``--sp 2 --offload_blocks`` shard it, each held to the same
       step in the same memory mode without the mesh, computed first in a
       fresh process with the card to itself (``memory_reference``):
       PAR_FSDP_REL_TOL under ``--fsdp``, PAR_STEP_REL_TOL under ``--sp``;
       K1 120 a step on every rank; the shards of the fp8 DiT fp8 and half
       its bytes; the resident parts sharded, no block on the card;
    2. ``infer.main`` at 1.3B on ``ck`` under each of MEM_CLI_MODES, one
       trajectory, MEM_CLI_STEPS steps a stage: K1 and K4 launched on
       every rank as many times as the run's steps and trajectories give,
       rank 0's clouds written, finite and of the CLI's shape.
    Host memory is checked first (MEM14_HOST_GIB). Returns ({path:
    launches}, stats)."""
    import os

    import torch

    from more4d_tpu_torch.utils.profiling import host_memory_gib

    host = host_memory_gib()
    log(f"mesh memory: host {', '.join(f'{k} {v:.1f} GiB' for k, v in host.items())}; "
        f"the two ranks pin ~{MEM14_HOST_GIB - 8} GiB of 14B blocks")
    if host.get("MemAvailable", MEM14_HOST_GIB) < MEM14_HOST_GIB:
        raise AssertionError(f"mesh memory: {host} available, the phase "
                             f"needs {MEM14_HOST_GIB} GiB")
    from PIL import Image

    rs = np.random.RandomState(3)
    image = os.path.join(root, "mesh_image.png")
    Image.fromarray((rs.rand(H, W, 3) * 255).astype(np.uint8)).save(image)
    argv = ["--image", image, "--prompt", PROMPT, "--seed", "0",
            "--control_ckpt", ck["control_dit"][0],
            "--inp_ckpt", ck["inp_dit"][0], "--vae_ckpt", ck["vae"][0],
            "--decoder_adaptor", ck["decoder_adaptor"][0],
            "--clip_ckpt", ck["clip"][0], "--omnimae_ckpt",
            ck["omnimae"][0], "--depth_ckpt", ck["unidepth"][0],
            "--model_size", "1.3b", "--allow_dummy_text",
            "--num_inference_steps", str(MEM_CLI_STEPS),
            "--trajectories", MEM_CLI_TRAJECTORIES, "--height", str(H),
            "--width", str(W), "--num_frames", str(FRAMES)]
    with open(os.path.join(root, "memory.json"), "w") as f:
        json.dump({"argv": argv, "root": root}, f)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = spawn_ranks(memory_reference, 1, root, dev)[0]
    stats = {"reference_wall_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ranks = spawn_ranks(memory_rank, PAR_WORLD, root, dev)
    stats["ranks_wall_s"] = time.perf_counter() - t0
    paths = {}
    cfg = dit_14b_configs()["motion"]
    for path, seq, mode in MEM14_MODES:
        tol = PAR_FSDP_REL_TOL if seq == 1 else PAR_STEP_REL_TOL
        rows = []
        for r, res in enumerate(ranks):
            got, want = res[path], ref[mode]
            err, rel = rel_err(got["out"], want["out"])
            same = torch.equal(got["out"], want["out"])
            row = dict(max_abs_err=err, rel_err=rel, same_bits=same,
                       wall_s=got["wall_s"],
                       reference_wall_s=want["wall_s"],
                       launches=got["launches"], **got["memory"],
                       **{k: got[k] for k in (
                           "pinned_gib", "fp8_local_bytes", "fp8_bytes",
                           "fp8_local_dtypes", "blocks_on_card")
                          if k in got})
            rows.append(row)
            log(f"mesh memory: 14B {path} ({mode}), rank {r}: against its "
                f"step without the mesh max abs {err:.3e}, relative "
                f"{rel:.3e} (tol {tol}), same bits {same}; wall "
                f"{got['wall_s']:.2f} s (two ranks on one card; without "
                f"the mesh, alone, {want['wall_s']:.2f} s); "
                f"K1 {got['launches']['flash_attention']}; peak "
                f"{got['memory']['peak_gib']:.2f} GiB, held "
                f"{got['memory']['held_gib']:.2f}, reserved "
                f"{got['memory']['reserved_gib']:.2f}, caught out-of-memory "
                f"errors {got['memory']['num_ooms']}"
                + (f"; pinned {got['pinned_gib']:.3f} GiB, blocks on the "
                   f"card {got['blocks_on_card']}" if mode == "offload"
                   else f"; fp8 shards {got['fp8_local_dtypes']}, "
                        f"{got['fp8_local_bytes'] / 2 ** 30:.3f} of "
                        f"{got['fp8_bytes'] / 2 ** 30:.3f} GiB")
                + f"; on {smi}")
            if not (got["sharded"] and rel <= tol
                    and torch.isfinite(got["out"]).all()):
                raise AssertionError(f"mesh memory {path}, rank {r}: "
                                     f"sharded {got['sharded']}, relative "
                                     f"error {rel:.3e}")
            if got["launches"]["flash_attention"] != 3 * cfg.num_layers:
                raise AssertionError(f"mesh memory {path}, rank {r}: "
                                     f"launches {got['launches']}")
            k5_check(f"mem14_{path}, rank {r}", got["launches"],
                     epilogues=False)
            k6_check(f"mem14_{path}, rank {r}", got["launches"], fp8=True)
            if mode == "fp8" and not (
                    got["fp8_local_dtypes"] == ["torch.float8_e4m3fn"]
                    and got["fp8_bytes"] == got["fp8_bytes_before"]
                    and abs(PAR_WORLD * got["fp8_local_bytes"]
                            - got["fp8_bytes"]) <= 0.01 * got["fp8_bytes"]):
                raise AssertionError(f"mesh memory {path}, rank {r}: fp8 "
                                     f"shards {got['fp8_local_dtypes']}, "
                                     f"{got['fp8_local_bytes']} of "
                                     f"{got['fp8_bytes']} bytes")
            if mode == "offload" and got["blocks_on_card"]:
                raise AssertionError(f"mesh memory {path}: blocks on the "
                                     f"card")
        stats[f"mem14_{path}"] = rows
        paths[f"mem14_{path}"] = ranks[0][path]["launches"]
    from more4d_tpu_torch import config as tconfig

    n_layers = tconfig.dit_1_3b().num_layers
    for path, flags in MEM_CLI_MODES.items():
        rows = []
        n_traj = len(MEM_CLI_TRAJECTORIES.split(","))
        forwards = n_layers * MEM_CLI_STEPS * (1 + n_traj)
        want = {"flash_attention": 3 * forwards, "gs_splat": n_traj,
                "rownorm": K5_PER_BLOCK * forwards}
        for r, res in enumerate(ranks):
            got = res[path]
            row = {k: v for k, v in got.items()
                   if k not in ("coords", "files")}
            rows.append(row)
            log(f"mesh memory: infer.main {' '.join(flags)}, rank {r}: "
                f"rc {got['rc']}, {got['wall_s']:.2f} s (two ranks on one "
                f"card, the load included); launches {got['launches']} "
                f"(expected {want}); sharded {got['sharded']}; "
                + (f"fp8 shards {got['fp8_local_dtypes']}, "
                   f"{got['fp8_local_bytes'] / 2 ** 30:.3f} of "
                   f"{got['fp8_bytes'] / 2 ** 30:.3f} GiB"
                   if "fp8_bytes" in got else
                   f"pinned {got['pinned_gib']:.3f} GiB, blocks on the "
                   f"card {got['blocks_on_card']}")
                + f"; peak {got['memory']['peak_gib']:.2f} GiB, caught "
                f"out-of-memory errors {got['memory']['num_ooms']}; files "
                f"{got['files']}")
            if got["rc"] != 0 or not got["sharded"] or \
                    got["launches"] != want or not (
                        got.get("pinned", True)
                        and not got.get("blocks_on_card")):
                raise AssertionError(f"mesh memory {path}, rank {r}: {row}")
            k6_check(f"{path}, rank {r}", got["k6"], fp8=True)
        coords = ranks[0][path].get("coords")
        if coords is None or coords.shape != (FRAMES, H * W, 3) or \
                not np.isfinite(coords).all():
            raise AssertionError(f"mesh memory {path}: rank 0 wrote no "
                                 f"finite clouds")
        stats[path] = rows
        paths[path] = ranks[0][path]["launches"]
    log(f"mesh memory on {smi}: launches {paths}")
    return paths, stats


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
    walls, t_phase = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = round(now - t_phase[0], 1)
        t_phase[0] = now

    k1, k1_err, k1_tol = flash_phase(dev)
    bwd = flash_bwd_phase(dev)
    k4, k4_err, k4_tol = splat_phase(dev)
    k5 = rownorm_phase(dev)
    k5_bwd = rownorm_bwd_phase(dev)
    k6 = widen_phase(dev, smi)
    lap("kernels")
    towers, tower_stats = towers_phase(dev)
    lap("towers")
    m, encoders, launches, stats = main_path(dev, towers)
    teacache = teacache_phase(dev, m, encoders)
    lap("main_path+teacache")
    del m, encoders
    gc.collect()
    torch.cuda.empty_cache()
    vism_launches, vism_stats = vism_train_phase(dev, towers)
    lap("vism_train")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ck = write_cli_checkpoints(root, dev)
        log(f"cli: wrote the checkpoints in {time.perf_counter() - t0:.1f} "
            f"s: " + ", ".join(f"{k} {b / 2 ** 30:.3f} GiB"
                               for k, (_, b) in ck.items()))
        straag_launches, straag = straag_cli_phase(dev, smi, towers, ck,
                                                   root)
        lap("straag_cli")
        del towers
        gc.collect()
        torch.cuda.empty_cache()
        cli = cli_phase(dev, smi, ck, root)
        lap("cli")
        gc.collect()
        torch.cuda.empty_cache()
        mem_launches, mem = mesh_memory_phase(dev, smi, ck, root)
    lap("mesh_memory")
    cli_launches = cli["runs"]["flow_dpm++"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    k14_launches, k14 = dit14b_phase(dev, smi)
    vism14 = k14.pop("vism14b")
    lap("dit14b")
    vae_stats = vae_train_phase(dev)
    lap("vae_train")
    gc.collect()
    torch.cuda.empty_cache()
    mesh_launches, mesh = parallel_phase(dev, smi)
    lap("parallel")
    log(f"phase walls (s): {walls}")
    vism_paths = {"vism_1.3b": vism_launches["vism_1.3b"],
                  "vism_1.3b_came_accum": vism_launches[
                      "vism_1.3b_came_accum"],
                  "vism_1.3b_te": vism_launches["vism_1.3b_te"],
                  "vism_14b": vism14["launches"]}
    cli_modes = {m: cli["runs"][m]["launches"] for m in CLI_MEMORY_MODES}
    sa, fr, sb = k1["self"], k4["trajectory"], bwd["self"]
    # K1 a calc step at 1.3B as teacache_phase counted it, step by step
    k1_calc_1_3b = float(np.mean([
        k for r in teacache for k, c in zip(r["k1_per_step"], r["sequence"])
        if c == "C"]))
    k5_calc_1_3b = float(np.mean([
        k for r in teacache for k, c in zip(r["k5_per_step"], r["sequence"])
        if c == "C"]))

    def bwd_entry(kind, grads, line):
        errs = {c: max(v["errors"][g]["max_abs_err"] for g in grads)
                for c, v in bwd.items()}
        return dict(
            name=f"flash_attention_bwd_{kind}", route="cuda",
            source="more4d_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=f"more4d_tpu/kernels/flash_attention.py:{line}",
            launches=straag_launches["straag_cli"][
                f"flash_attention_bwd_{kind}"],
            launches_by_path={
                **{p: n[f"flash_attention_bwd_{kind}"]
                   for p, n in straag_launches.items()},
                **{p: n[f"flash_attention_bwd_{kind}"]
                   for p, n in vism_paths.items()},
                **{p: n[f"flash_attention_bwd_{kind}"]
                   for p, n in mesh_launches.items()
                   if p.startswith("straag")}},
            launches_per_vism_14b_step=vism14["launches_per_step"][
                f"flash_attention_bwd_{kind}"],
            launches_per_straag_step={
                p: straag[p]["launches_per_step"][
                    f"flash_attention_bwd_{kind}"]
                for p in ("nothing",) + STRAAG_POLICIES},
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
             launches_by_path={
                 "run_two_stage": launches["flash_attention"],
                 "cli": cli_launches["flash_attention"],
                 **{f"cli_{m}": n["flash_attention"]
                    for m, n in cli_modes.items()},
                 **{p: n["flash_attention"]
                    for p, n in straag_launches.items()},
                 **{p: n["flash_attention"]
                    for p, n in k14_launches.items()},
                 **{p: n["flash_attention"] for p, n in vism_paths.items()},
                 **{p: n["flash_attention"]
                    for p, n in mesh_launches.items()},
                 **{p: n["flash_attention"]
                    for p, n in mem_launches.items()}},
             launches_per_vism_14b_step=vism14["launches_per_step"][
                 "flash_attention"],
             launches_per_straag_step={
                 p: straag[p]["launches_per_step"]["flash_attention"]
                 for p in ("nothing",) + STRAAG_POLICIES},
             launches_per_calc_step={"1.3b": k1_calc_1_3b,
                                     "14b": k14["k1_per_step"]},
             launches_by_teacache_step={
                 f"{r['threshold']:.4g}"
                 + (" offload_residual" if r["offload_residual"] else ""):
                     dict(zip(r["sequence"], r["k1_per_step"]))
                 for r in teacache},
             max_abs_err=k1_err,
             tolerance=k1_tol, ms=sa["ms"], plain_ms=sa["plain_ms"],
             bound_ms=sa["bound_ms"], bound_by=sa["bound_by"],
             library_ms=sa["library_ms"],
             shape="self-attention q/k/v [2,9568,12,128] bf16",
             ptxas=regs("flash_fwd_kernel<128>"),
             cases={k: {kk: vv for kk, vv in v.items()
                        if kk not in ("flops", "bytes")}
                    for k, v in {**k1, **mesh["k1"]}.items()}),
        bwd_entry("dq", ("dq",), 216),
        bwd_entry("dkv", ("dk", "dv"), 250),
        dict(name="gs_splat", route="cuda",
             source="more4d_tpu_torch/csrc/gs_splat.cu",
             replaces="more4d_tpu/kernels/gs_splat.py:121",
             launches=launches["gs_splat"],
             launches_by_path={
                 "run_two_stage": launches["gs_splat"],
                 "cli": cli_launches["gs_splat"],
                 **{f"cli_{m}": n["gs_splat"] for m, n in cli_modes.items()},
                 **{p: n["gs_splat"] for p, n in k14_launches.items()},
                 **{p: n["gs_splat"]
                    for p, n in {**mesh_launches, **mem_launches}.items()
                    if "gs_splat" in n}},
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
        dict(name="rownorm", route="cuda",
             source="more4d_tpu_torch/csrc/rownorm.cu",
             replaces="none: XLA fuses these chains in the JAX package",
             launches=launches["rownorm"],
             launches_by_path={
                 "run_two_stage": launches["rownorm"],
                 "cli": cli_launches["rownorm"],
                 **{f"cli_{m}": n["rownorm"] for m, n in cli_modes.items()},
                 **{p: n["rownorm"] for p, n in straag_launches.items()},
                 **{p: n["rownorm"] for p, n in k14_launches.items()},
                 **{p: n["rownorm"] for p, n in vism_paths.items()},
                 **{p: n["rownorm"]
                    for p, n in {**mesh_launches, **mem_launches}.items()}},
             launches_by_epilogue=K5_EPILOGUES,
             launches_per_calc_step={
                 "1.3b": k5_calc_1_3b,
                 "14b": k14_launches["run_two_stage_14b"]["rownorm"]
                 / (3 * STEPS)},
             launches_by_teacache_step={
                 f"{r['threshold']:.4g}"
                 + (" offload_residual" if r["offload_residual"] else ""):
                     dict(zip(r["sequence"], r["k5_per_step"]))
                 for r in teacache},
             max_abs_err=max(c["max_err"] for v in k5.values()
                             for s, c in v.items() if s != "block"),
             ms=k5["1.3b"]["adaln_film"]["ms"],
             plain_ms=k5["1.3b"]["adaln_film"]["plain_ms"],
             bound_ms=k5["1.3b"]["adaln_film"]["bound_ms"],
             bound_by=k5["1.3b"]["adaln_film"]["bound_by"], library_ms=None,
             ptxas=regs("more4d_rownorm_kernel<4,1>"),
             shape="adaLN + FiLM over [2,9568,1536] bf16",
             cases={f"{k}_{s}": c for k, v in k5.items()
                    for s, c in v.items()}),
        dict(name="rownorm_bwd", route="cuda",
             source="more4d_tpu_torch/csrc/rownorm.cu",
             replaces="none: autograd of the eager chains K5 replaces",
             launches=straag_launches["straag_cli"]["rownorm_bwd"],
             launches_by_path={
                 **{p: n["rownorm_bwd"] for p, n in straag_launches.items()},
                 **{p: n["rownorm_bwd"] for p, n in vism_paths.items()},
                 **{p: n["rownorm_bwd"] for p, n in mesh_launches.items()
                    if "rownorm_bwd" in n}},
             launches_per_straag_step={
                 p: straag[p]["launches_per_step"]["rownorm_bwd"]
                 for p in ("nothing",) + STRAAG_POLICIES},
             ms=k5_bwd["1.3b_b1"]["adaln_film"]["ms"],
             plain_ms=k5_bwd["1.3b_b1"]["adaln_film"]["plain_ms"],
             bound_ms=k5_bwd["1.3b_b1"]["adaln_film"]["bound_ms"],
             bound_by=k5_bwd["1.3b_b1"]["adaln_film"]["bound_by"],
             library_ms=None,
             ptxas=regs("more4d_rownorm_bwd_kernel<4,1,0>"),
             shape="adaLN + FiLM backward over [1,9568,1536] bf16",
             cases={f"{k}_{s}": c for k, v in k5_bwd.items()
                    for s, c in v.items()}),
        dict(name="widen_fp8", route="cuda",
             source="more4d_tpu_torch/csrc/widen.cu",
             replaces="none: XLA fuses the cast into the product's read",
             launches=k6["paths"]["fp8"]["k6_a_forward"],
             launches_by_path=dict(K6_BY_PATH),
             launches_per_forward={p: v["k6_a_forward"]
                                   for p, v in k6["paths"].items()},
             k1_per_forward={p: v["k1_a_forward"]
                             for p, v in k6["paths"].items()},
             ms=k6["fc1"]["ms"], plain_ms=k6["fc1"]["plain_ms"],
             bound_ms=k6["fc1"]["bound_ms"], bound_by=k6["fc1"]["bound_by"],
             library_ms=None, ptxas=regs("more4d_widen_fp8_kernel<0,0>"),
             ptxas_fp32=regs("more4d_widen_fp8_kernel<1,0>"),
             shape="fc1's fp8 weight [13824,5120] to bf16",
             cases={k: v for k, v in k6.items() if k != "paths"}),
    ]
    log("main path stats: " + json.dumps(
        {k: round(v, 4) for k, v in stats.items()}))
    log("towers: " + json.dumps(tower_stats))
    log("teacache: " + json.dumps(teacache))
    log(f"cli on {smi}: " + json.dumps(cli))
    log(f"14b on {smi}: " + json.dumps(k14))
    log(f"straag on {smi}: " + json.dumps(straag))
    log(f"vism 1.3b on {smi}: " + json.dumps(vism_stats))
    log(f"vism 14b on {smi}: " + json.dumps(vism14))
    log(f"vae adaptor training on {smi}: " + json.dumps(vae_stats))
    log(f"mesh on {smi}: " + json.dumps(
        {k: v for k, v in mesh.items() if k != "k1"}))
    log(f"mesh memory modes on {smi}: " + json.dumps(mem))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
