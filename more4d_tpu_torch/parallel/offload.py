"""DiT block weights streamed from pinned host memory: the 14B on one card
(PyTorch port of ``more4d_tpu/parallel/offload.py``).

- Each block's weights sit in one flat host buffer, pinned, fp8 for the
  large matrices and bf16 for the rest (``offload_blocks_to_host``,
  ``make_host_blocks``); the embeddings, head and norms stay on the card
  in bf16 (the resident ``WanDiT``, its block list empty).
- ``StreamedDiT`` walks the stack with two device buffers: block k+1 is
  copied host -> card on a copy stream of its own while block k computes
  on the compute stream. Events order the reuse: the copy into a buffer
  waits for the compute that last read it, the compute waits for its
  copy. The fp8 weights are widened by each layer on the compute stream.
- A source that is not pinned raises: ``non_blocking=True`` from pageable
  memory is a synchronous copy, and nothing would say so.
- The walk runs under the span ``more4d.dit.backbone``, as the resident
  stack does, and each block's copy is issued under ``more4d.stream.fetch``
  (``utils/profiling.py``); ``StreamedDiT.copies`` and
  ``StreamedDiT.copied_bytes`` count the copies issued and their bytes.

On the CPU (the tests) nothing is copied: each block runs on its host
buffer.

The denoise loop is the pipelines' (``diffusion/loop.py``) over
``StreamedDiT.backbone``, with TeaCache's schedule rule
(``ScheduleTeaCache``: the decisions for the whole schedule from
``time_embed_e0`` of every timestep before the first step, as the JAX
package's streamed loop takes them).

On a mesh the resident part may be sharded with FSDP2 (``placement.py``):
its ``embed``, ``finalize`` and ``time_embed_e0`` gather it, and each rank
streams the whole blocks from its own pinned copy; under an installed seq
mesh the block walk runs on the rank's L/S tokens (``seq_shard``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import resolve_device
from ..config import DiTConfig
from ..diffusion import loop
from ..models.wan_dit import WanBlock, WanDiT, seq_shard, zero_mpm_fallback
from ..utils.profiling import spanned
from ..utils.quantize import FP8, _should_quantize

# pinned host memory comes in chunks of this many bytes at most: torch's
# pinned allocator rounds every request up to a power of two, so one 14B
# block (0.42 GB) alone would pin 0.54 GB
PINNED_CHUNK = 1 << 31
_ALIGN = 256


def _fp8_eligible(path: str, shape) -> bool:
    """``utils/quantize._should_quantize`` on a per-layer block tensor."""
    return _should_quantize(path, len(shape))


def _quantized_dtype(quantize: str, path: str, shape, orig_dtype):
    """The storage dtype of a host block tensor: ``'none'`` keeps the
    original; otherwise fp8 for an eligible matrix under ``'fp8'`` and
    bf16 for everything else, whatever the model's dtype (the JAX rule)."""
    if quantize == "none":
        return orig_dtype
    if quantize == "fp8" and _fp8_eligible(path, shape):
        return FP8
    return torch.bfloat16


@dataclasses.dataclass
class HostBlock:
    """One block's weights: ``tensors`` (the block's state dict) are views
    of the one flat byte buffer ``flat``, pinned for the card."""

    flat: torch.Tensor
    tensors: Dict[str, torch.Tensor]


def _layout(specs: Sequence[Tuple[str, tuple, torch.dtype]]):
    """(offsets, bytes) of tensors packed into one buffer, each start
    aligned to _ALIGN bytes."""
    offsets, n = [], 0
    for _, shape, dtype in specs:
        offsets.append(n)
        size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        n += -(-size // _ALIGN) * _ALIGN
    return offsets, n


def _views(flat: torch.Tensor, specs, offsets) -> Dict[str, torch.Tensor]:
    out = {}
    for (name, shape, dtype), off in zip(specs, offsets):
        size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        out[name] = flat[off:off + size].view(dtype).view(shape)
    return out


def _host_buffers(nbytes: int, count: int, pin: bool) -> List[torch.Tensor]:
    """``count`` host byte buffers of ``nbytes``; pinned ones are cut from
    chunks of at most PINNED_CHUNK bytes (see there)."""
    if not pin:
        return [torch.empty(nbytes, dtype=torch.uint8) for _ in range(count)]
    per = max(1, PINNED_CHUNK // nbytes)
    out = []
    for first in range(0, count, per):
        n = min(per, count - first)
        chunk = torch.empty(n * nbytes, dtype=torch.uint8, pin_memory=True)
        if not chunk.is_pinned():
            raise RuntimeError("host block memory could not be pinned")
        out += list(chunk.view(n, nbytes).unbind(0))
    return out


def _block_specs(named: Dict[str, tuple], quantize: str):
    """[(name, shape, storage dtype)] of a block from {name: (shape,
    dtype)}, in state-dict order."""
    return [(k, shape, _quantized_dtype(quantize, k, shape, dtype))
            for k, (shape, dtype) in named.items()]


def split_block_params(model: WanDiT) -> Tuple[WanDiT, List[Dict]]:
    """(resident, blocks): ``model`` with its block list emptied (the
    embeddings, head and norms), and each block's state dict."""
    blocks = [blk.state_dict() for blk in model.blocks]
    model.blocks = nn.ModuleList()
    return model, blocks


@torch.no_grad()
def offload_blocks_to_host(blocks: Sequence[Dict[str, torch.Tensor]],
                           quantize: str = "fp8", device="cuda"
                           ) -> Tuple[HostBlock, ...]:
    """Each block's state dict cast to its storage dtype (fp8 for large
    matrices, bf16 for norms, modulation and vectors; ``'none'`` keeps
    the dtype) into one host buffer a block, pinned when ``device`` is the
    card."""
    dev = resolve_device(device)
    specs = _block_specs({k: (tuple(v.shape), v.dtype)
                          for k, v in blocks[0].items()}, quantize)
    offsets, nbytes = _layout(specs)
    flats = _host_buffers(nbytes, len(blocks), dev.type == "cuda")
    host = []
    for flat, sd in zip(flats, blocks):
        views = _views(flat, specs, offsets)
        for name, v in views.items():
            v.copy_(sd[name].to(v.dtype))
        host.append(HostBlock(flat, views))
    return tuple(host)


@torch.no_grad()
def make_host_blocks(cfg: DiTConfig, num_layers: int, quantize: str = "fp8",
                     device="cuda", seed: Optional[int] = None):
    """(resident, host blocks) with no checkpoint: ``num_layers`` blocks of
    ``cfg`` made one at a time on ``device`` (zeros, or N(0, 0.02) in bf16
    from a generator seeded ``seed + i`` for block i) and cast to their
    storage dtypes straight into host buffers (pinned for the card); the
    resident part zeros in bf16 on ``device``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        resident = WanDiT(cfg)
    named = {k: (tuple(v.shape), torch.bfloat16)
             for k, v in resident.blocks[0].state_dict().items()}
    resident.blocks = nn.ModuleList()
    specs = _block_specs(named, quantize)
    offsets, nbytes = _layout(specs)
    flats = _host_buffers(nbytes, num_layers, dev.type == "cuda")
    stage = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    staged = _views(stage, specs, offsets)
    host = []
    for i, flat in enumerate(flats):
        g = None if seed is None else torch.Generator(dev).manual_seed(
            seed + i)
        for (name, shape, _), v in zip(specs, staged.values()):
            if g is None:
                v.zero_()
            else:
                v.copy_(torch.randn(shape, generator=g, device=dev,
                                    dtype=torch.bfloat16) * 0.02)
        flat.copy_(stage)
        host.append(HostBlock(flat, _views(flat, specs, offsets)))
    resident = resident.to(torch.bfloat16).to_empty(device=dev)
    for p in resident.parameters():
        p.zero_()
    return resident.eval(), tuple(host)


def _bind(cfg: DiTConfig, tensors: Dict[str, torch.Tensor]) -> WanBlock:
    """A ``WanBlock`` whose parameters are ``tensors`` (views, not
    copies)."""
    with torch.device("meta"):
        blk = WanBlock(cfg).requires_grad_(False)
    blk.load_state_dict(tensors, strict=True, assign=True)
    return blk.eval()


class StreamedDiT:
    """A ``WanDiT`` whose block weights stream from host memory.

    ``model``: the resident part (``split_block_params`` or
    ``make_host_blocks``), moved to ``device``; ``host_blocks``: its
    blocks from ``offload_blocks_to_host`` or ``make_host_blocks``, pinned
    when ``device`` is the card (checked here).

    ``StreamedDiT.copies`` and ``StreamedDiT.copied_bytes`` count, over
    every instance, the block copies issued host -> card and their bytes
    (none on the CPU, where nothing is copied)."""

    copies = 0
    copied_bytes = 0

    def __init__(self, model: WanDiT, host_blocks: Sequence[HostBlock],
                 device="cuda", rope_tables=None):
        self.device = resolve_device(device)
        self.host_blocks = tuple(host_blocks)
        cuda = self.device.type == "cuda"
        if cuda:
            unpinned = [i for i, hb in enumerate(self.host_blocks)
                        if not hb.flat.is_pinned()]
            if unpinned:
                raise ValueError(f"StreamedDiT: host blocks {unpinned} are "
                                 f"not in pinned memory; a copy from "
                                 f"pageable memory would be synchronous")
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.rope_tables = rope_tables
        self._copy = None
        if not cuda or not self.host_blocks:
            # no copies: each block runs on its host buffer
            self._blocks = [_bind(self.cfg, hb.tensors)
                            for hb in self.host_blocks]
            return
        hb = self.host_blocks[0]
        self._flats = [torch.empty_like(hb.flat, device=self.device)
                       for _ in range(2)]
        self._slots = [_bind(self.cfg, _views_like(hb, f))
                       for f in self._flats]
        self._copy = torch.cuda.Stream(self.device)
        for flat in self._flats:
            # the allocator must not hand a buffer out while a copy into
            # it may still run
            flat.record_stream(self._copy)
        self._ready = [torch.cuda.Event() for _ in range(2)]
        self._free = [torch.cuda.Event() for _ in range(2)]

    # -- the block walk ------------------------------------------------ #

    @spanned("more4d.stream.fetch")
    def _fetch(self, k: int) -> None:
        """Block k's copy into buffer k % 2 on the copy stream, after the
        compute that last read that buffer."""
        if self._copy is None:
            return
        s = k % 2
        src = self.host_blocks[k].flat
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(self._free[s])
            self._flats[s].copy_(src, non_blocking=True)
            self._ready[s].record(self._copy)
        StreamedDiT.copies += 1
        StreamedDiT.copied_bytes += src.numel()

    def _enter(self, k: int) -> WanBlock:
        """Block k, its weights on the device once the compute stream gets
        here."""
        if self._copy is None:
            return self._blocks[k]
        torch.cuda.current_stream(self.device).wait_event(self._ready[k % 2])
        return self._slots[k % 2]

    def _leave(self, k: int) -> None:
        if self._copy is not None:
            self._free[k % 2].record(torch.cuda.current_stream(self.device))

    @spanned("more4d.dit.backbone")
    def backbone(self, it):
        """The block stack over ``it`` (``WanDiT.embed``'s), block k+1's
        copy in flight while block k computes. Under an installed seq mesh
        each rank runs the blocks on its L/S tokens and the output is
        gathered whole, as ``WanDiT.backbone`` does (``seq_shard``)."""
        mpm, mask = zero_mpm_fallback(self.cfg, it.tokens, it.mpm_tokens,
                                      it.mpm_mask)
        (x, e0, cos, sin, mpm, mask), gather = seq_shard(it, mpm, mask)
        n = len(self.host_blocks)
        if n:
            self._fetch(0)
        for k in range(n):
            if k + 1 < n:
                self._fetch(k + 1)
            x = self._enter(k)(x, e0, it.context, cos, sin, it.kv_lens, mpm,
                               mask)
            self._leave(k)
        return gather(x)

    def copy_blocks(self) -> None:
        """Every block's copy through the two buffers and nothing else
        (what the stream costs alone)."""
        for k in range(len(self.host_blocks)):
            self._fetch(k)
            self._enter(k)
            self._leave(k)

    def device_blocks(self) -> nn.ModuleList:
        """The blocks as the resident model would hold them: each host
        buffer copied to the device once, at its storage dtypes."""
        return nn.ModuleList(
            _bind(self.cfg, _views_like(hb, hb.flat.to(self.device)))
            for hb in self.host_blocks)

    @torch.no_grad()
    def __call__(self, x, t, context, **kw):
        it = self.model.embed(x, t, context, rope_tables=self.rope_tables,
                              **kw)
        return self.model.finalize(self.backbone(it), it)

    def denoise(self, scheduler, latents, prompt_embeds, neg_embeds=None,
                y=None, clip_fea=None, mpm_features=None,
                guidance_scale: float = 6.0, cfg_skip_ratio: float = 0.0,
                teacache: Optional[loop.ScheduleTeaCache] = None):
        """The pipelines' denoise loop (``diffusion/loop.py``) over this
        walk, with this DiT's rope tables. ``BasePipeline.denoise`` could
        call the loop itself: this method stays only because the
        benchmark's test of the streamed cell (``h100_bench/tests/
        test_h100_bench_stream.py::test_the_timed_path_is_the_clis_streamed_
        loop``) patches it by name. Once that test names
        ``StreamedDiT.backbone``, it can go."""
        forward = functools.partial(loop.dit_forward, self.model,
                                    self.backbone, self.rope_tables)
        return loop.denoise(
            self.model, functools.partial(loop.sampler_step, forward,
                                          scheduler),
            scheduler, self.device, latents, prompt_embeds,
            neg_embeds=neg_embeds, y=y, clip_fea=clip_fea,
            mpm_features=mpm_features, guidance_scale=guidance_scale,
            cfg_skip_ratio=cfg_skip_ratio, teacache=teacache)


def _views_like(hb: HostBlock, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``hb``'s tensors as views of ``flat``, a buffer of its layout."""
    base = hb.flat.data_ptr()
    return {k: flat[v.data_ptr() - base:][:v.numel() * v.element_size()]
            .view(v.dtype).view(v.shape) for k, v in hb.tensors.items()}
