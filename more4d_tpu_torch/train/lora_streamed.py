"""LoRA training against a DiT whose frozen block weights stream from
pinned host memory: the 14B on one card (PyTorch port of
``more4d_tpu/train/lora_streamed.py``).

``StreamedLoRATrainer`` extends ``parallel.offload.StreamedDiT``'s walk
with a backward walk:

- **Forward walk**, under ``torch.no_grad()``: block k+1's copy in flight
  while block k runs, as ``StreamedDiT.backbone`` does; each block's
  input is kept, on the card or (``acts_on_host``) in pinned host memory,
  copied there on the copy stream.
- **Loss tail**: ``finalize`` and the thresholded MSE, with a gradient
  to the tokens only.
- **Backward walk**, k = L-1 ... 0: block k-1's copy prefetched while
  block k runs again from its saved input under ``torch.enable_grad()``
  (gradient checkpointing at block granularity), then
  ``torch.autograd.backward`` from the incoming gradient; the input's
  gradient goes on to block k-1, the factors' gradients accumulate. A
  buffer's ``free`` event is recorded only after its block's backward: a
  bf16 block's ``Linear`` saves its weight as a view into the buffer, and
  a copy into it before the backward ran would change dx silently.
- **Update**: the factors' gradients clipped by their global norm, then
  the optimizer (``optim.GradUpdate``). The loss is read once a step.

LoRA is a side path on every matched ``Linear`` of the bound block,
``dense(x) + scale * (x @ down^T) @ up^T`` (a forward hook): merging W +
scale * up @ down would make a full-size delta and a merged copy of every
weight, ~1.7 GiB in flight a 14B block. The JAX module merges only for
its fused-qkv projections; the port's q, k and v are separate ``Linear``s,
so they take the side path too. The JAX module also walks the backward in
chunks of ``bwd_chunk`` blocks to bound XLA's temporaries in one graph;
eager PyTorch frees each block's autograd graph after its backward, so
the walk is one loop and there is no chunk size.

Timestep indices and noise come from the caller, as in the resident step
(``train_vism``). A step at 14B launches K1 240 times (the forward walk
and the recompute, three attentions a block), K2 and K3 120 each.

Spans (``utils/profiling.py``): ``more4d.lora.forward_walk``,
``.loss``, ``.backward_walk`` and ``.update`` around the step's four
parts, ``more4d.lora.side`` around each side path; the block copies
keep ``StreamedDiT``'s ``more4d.stream.fetch``.
``StreamedLoRATrainer.side_paths`` counts the side paths applied, over
every instance (12 ``Linear``s a block, twice a step: 960 at 14B).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..models.wan_dit import WanDiT, zero_mpm_fallback
from ..parallel.offload import StreamedDiT
from ..utils.profiling import span, spanned
from .lora import DEFAULT_TARGETS, create_lora
from .train_straag import flow_inputs
from .optim import GradUpdate
from .train_vism import VismTrainConfig, factor_leaves, vism_loss


def lora_block_paths(factors: dict) -> Dict[int, Dict[str, str]]:
    """{layer: {module path in the block: weight name}} of the factors in
    the blocks (``blocks.3.self_attn.q.weight`` -> layer 3, module
    ``self_attn.q``); factors outside the blocks are left out."""
    out: Dict[int, Dict[str, str]] = {}
    for name in factors:
        parts = name.split(".")
        if parts[0] == "blocks" and parts[-1] == "weight":
            out.setdefault(int(parts[1]), {})[".".join(parts[2:-1])] = name
    return out


class StreamedLoRATrainer(StreamedDiT):
    """Train a LoRA's factors against a host-streamed frozen base.

    ``model`` and ``host_blocks`` as for ``StreamedDiT``; the LoRA is
    ``create_lora``'s on the full model's state dict (factors on the
    device, float32). ``cfg`` carries the loss, sampling and clip
    settings."""

    side_paths = 0

    def __init__(self, model: WanDiT, host_blocks, cfg: VismTrainConfig,
                 lora_rank: int = 4, lora_alpha: float = 1.0,
                 device="cuda", rope_tables=None,
                 acts_on_host: bool = False):
        super().__init__(model, host_blocks, device=device,
                         rope_tables=rope_tables)
        self.tcfg = cfg
        self.scale = float(cfg.lora_multiplier * lora_alpha / lora_rank)
        self.acts_on_host = bool(acts_on_host)
        self._active: Dict[str, tuple] = {}
        self._hook(self._blocks if self._copy is None else self._slots)

    def _hook(self, blocks) -> None:
        """The side path on every ``Linear`` of ``blocks``, the modules
        the walk runs."""
        for blk in blocks:
            for path, mod in blk.named_modules():
                if isinstance(mod, nn.Linear):
                    mod.register_forward_hook(self._side_path(path))

    def _side_path(self, path: str):
        def hook(module, args, out):
            f = self._active.get(path)
            if f is None:
                return out
            StreamedLoRATrainer.side_paths += 1
            with span("more4d.lora.side"):
                down, up = (t.to(out.dtype) for t in f)
                x = args[0].to(out.dtype)
                return out + self.scale * ((x @ down.T) @ up.T)
        return hook

    def _run_block(self, blk, h, it, mpm, mask, layer_factors):
        self._active = layer_factors
        try:
            return blk(h, it.e0, it.context, it.rope_cos, it.rope_sin,
                       it.kv_lens, mpm, mask)
        finally:
            self._active = {}

    # -- the walks ------------------------------------------------------ #

    def _to_host(self, h: torch.Tensor) -> torch.Tensor:
        """h copied to pinned host memory on the copy stream, after the
        compute that made it (on the CPU, a copy)."""
        if self._copy is None:
            return h.clone()
        dst = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
        self._copy.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy):
            dst.copy_(h, non_blocking=True)
        h.record_stream(self._copy)
        return dst

    def _load(self, saved, k: int):
        """Block k's saved input; with ``acts_on_host`` its copy back to
        the card issued on the copy stream, and the event that ends it."""
        if not self.acts_on_host or self._copy is None:
            return saved[k], None
        ev = torch.cuda.Event()
        with torch.cuda.stream(self._copy):
            out = saved[k].to(self.device, non_blocking=True)
            ev.record(self._copy)
        return out, ev

    @spanned("more4d.lora.forward_walk")
    @torch.no_grad()
    def forward_walk(self, it, layers: Dict[int, dict]):
        """(the block stack's output tokens, each block's input)."""
        mpm, mask = zero_mpm_fallback(self.cfg, it.tokens, it.mpm_tokens,
                                      it.mpm_mask)
        h, n = it.tokens, len(self.host_blocks)
        saved: List[torch.Tensor] = []
        self._fetch(0)
        for k in range(n):
            saved.append(self._to_host(h) if self.acts_on_host else h)
            if k + 1 < n:
                self._fetch(k + 1)
            h = self._run_block(self._enter(k), h, it, mpm, mask,
                                layers.get(k, {}))
            self._leave(k)
        return h, saved

    @spanned("more4d.lora.backward_walk")
    def backward_walk(self, it, layers: Dict[int, dict], saved, g):
        """Each block again from its saved input, last first, and its
        backward from ``g``; the factors' gradients accumulate in their
        ``.grad``."""
        mpm, mask = zero_mpm_fallback(self.cfg, it.tokens, it.mpm_tokens,
                                      it.mpm_mask)
        n = len(self.host_blocks)
        self._fetch(n - 1)
        act = self._load(saved, n - 1)
        for k in reversed(range(n)):
            h_in, ev = act
            saved[k] = None
            if k > 0:
                self._fetch(k - 1)
                act = self._load(saved, k - 1)
            blk = self._enter(k)
            if ev is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ev)
                h_in.record_stream(compute)
            h_in = h_in.detach().requires_grad_(True)
            with torch.enable_grad():
                out = self._run_block(blk, h_in, it, mpm, mask,
                                      layers.get(k, {}))
                torch.autograd.backward(out, g)
            g = h_in.grad
            del out, h_in
            # only now may the buffer take another block (see the module
            # note)
            self._leave(k)
        return g

    def loss_and_grads(self, lora, batch, idx, noise) -> float:
        """The loss of one batch; the factors' gradients left in their
        ``.grad``."""
        cfg = self.tcfg
        leaves = factor_leaves(lora)
        for leaf in leaves:
            leaf.requires_grad_(True)
            leaf.grad = None
        dev = self.device
        zt, t, target, weight = flow_inputs(
            cfg, batch["latents"].to(dev), idx, noise)
        with torch.no_grad():
            it = self.model.embed(
                zt, t, batch["context"].to(dev),
                y=_put(batch.get("y"), dev),
                clip_fea=_put(batch.get("clip_fea"), dev),
                mpm_features=_put(batch.get("mpm_features"), dev),
                rope_tables=self.rope_tables)
        paths = lora_block_paths(lora["factors"])
        layers = {k: {p: (lora["factors"][name]["down"],
                          lora["factors"][name]["up"])
                      for p, name in ps.items()}
                  for k, ps in paths.items()}
        tokens, saved = self.forward_walk(it, layers)
        tokens = tokens.detach().requires_grad_(True)
        with span("more4d.lora.loss"), torch.enable_grad():
            loss = vism_loss(self.model.finalize(tokens, it), target, weight,
                             cfg)
            g, = torch.autograd.grad(loss, tokens)
        self.backward_walk(it, layers, saved, g)
        return loss.item()

    def train_step(self, lora, update: GradUpdate, batch, idx, noise
                   ) -> Dict[str, float]:
        """One micro-step: the factors' gradients through both walks, then
        ``update``. Returns {loss, grad_norm, updated}."""
        loss = self.loss_and_grads(lora, batch, idx, noise)
        with span("more4d.lora.update"):
            grads = [p.grad for p in factor_leaves(lora)]
            for p in factor_leaves(lora):
                p.grad = None
            return {"loss": loss, **update(grads)}


def _put(a, dev):
    return None if a is None else a.to(dev)


def make_streamed_lora_trainer(model, cfg: VismTrainConfig,
                               generator: torch.Generator, rank: int = 4,
                               alpha: float = 1.0, quantize: str = "fp8",
                               targets: Optional[str] = None,
                               skip_name: Optional[str] = None,
                               device="cuda", rope_tables=None,
                               acts_on_host: bool = False):
    """(trainer, lora). ``model``: a ``WanDiT``, split here (its blocks
    parked in host memory at ``quantize``'s storage dtypes, pinned for the
    card; ``model`` keeps the resident part), or a ``StreamedDiT`` whose
    blocks are already there. The LoRA comes from ``generator`` over the
    full model's weight names and shapes."""
    from ..parallel.offload import offload_blocks_to_host, split_block_params

    with torch.device("meta"):
        shapes = WanDiT(model.cfg).state_dict()
    lora = create_lora(shapes, generator, rank=rank, alpha=alpha,
                       targets=targets or DEFAULT_TARGETS,
                       skip_name=skip_name)
    if isinstance(model, StreamedDiT):
        resident, host = model.model, model.host_blocks
        rope_tables = rope_tables or model.rope_tables
    else:
        resident, blocks = split_block_params(model)
        host = offload_blocks_to_host(blocks, quantize=quantize,
                                      device=device)
        del blocks
    trainer = StreamedLoRATrainer(resident, host, cfg, lora_rank=rank,
                                  lora_alpha=alpha, device=device,
                                  rope_tables=rope_tables,
                                  acts_on_host=acts_on_host)
    return trainer, lora
