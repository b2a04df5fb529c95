"""Tracing (PyTorch port of ``more4d_tpu/utils/profiling.py``): the
program's named spans, and a ``torch.profiler`` trace (CPU, and the card's
kernels when CUDA is there) written as a Chrome trace, viewable in
Perfetto or TensorBoard.

A span is a ``torch.profiler.record_function`` range, entered only while a
profiler is recording: it lands in the profiler's trace on the clock of
the device's activities, so a trace puts each kernel, and each stretch in
which the device sat idle, down to the phase of the work that launched it.
With no profiler a span is one attribute read.
"""

from __future__ import annotations

import contextlib
import functools
import os

import torch
from torch.autograd import profiler as _profiler

# every span the program emits (``span``'s names)
SPANS = (
    # BasePipeline.denoise: one request, its inputs' placement, the sampler
    # loop, the CFG combine and the scheduler's steps
    "more4d.denoise",
    # WanDiT.embed: patch, text, CLIP and MPM embedding, RoPE, timesteps
    "more4d.dit.embed",
    # WanDiT.backbone: the block stack (under remat its forward pass); also
    # StreamedDiT.backbone, the stack's walk over blocks streamed from host
    # memory
    "more4d.dit.backbone",
    # WanDiT.finalize: the head and unpatchify
    "more4d.dit.finalize",
    # kernels/flash_attention.py flash_attention without autograd (K1 or its
    # plain version); with a gradient the op more4d_torch::flash_attn runs
    "more4d.attn",
    # train_straag.train_step: the DiT forward and the loss
    "more4d.train.forward",
    # train_step: loss.backward(), the remat recompute on autograd's thread
    "more4d.train.backward",
    # train_step: the gradient clamp, the loss and norm reads, the skip rule
    "more4d.train.clamp",
    # train_step: GradUpdate (its norm, AdamW) and releasing the gradients
    "more4d.train.optimizer",
    # train_step: the EMA's foreach update
    "more4d.train.ema",
    # parallel/offload.py StreamedDiT._fetch: the host's issue of one block's
    # copy host -> card on the copy stream
    "more4d.stream.fetch",
    # train/lora_streamed.py StreamedLoRATrainer: the forward walk over the
    # streamed blocks; the loss tail (finalize, the loss, its gradient to
    # the tokens); the backward walk (each block streamed in again, run
    # from its saved input and back-propagated); the factors' clip and
    # optimizer step
    "more4d.lora.forward_walk",
    "more4d.lora.loss",
    "more4d.lora.backward_walk",
    "more4d.lora.update",
    # the LoRA side path on one Linear, s (x down^T) up^T added to its
    # output (the forward hook; its backward runs on autograd's thread)
    "more4d.lora.side",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the work inside it ``name`` (one of ``SPANS``) in a
    running profiler's trace; with no profiler, a shared context that does
    nothing. It never synchronises, allocates or reads a tensor."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: each call of the function runs under ``span(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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


def host_memory_gib() -> dict:
    """The host's MemTotal and MemAvailable in GiB, from /proc/meminfo
    (empty where there is none)."""
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                if key in ("MemTotal", "MemAvailable"):
                    out[key] = int(rest.split()[0]) / 2 ** 20
    except OSError:
        pass
    return out
