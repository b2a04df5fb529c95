"""Closed-loop denoising of the DiT streamed from pinned host memory
(``--offload_blocks``), one client: each request is one
``WanControlPipeline.denoise``, which hands its loop to
``StreamedDiT.denoise`` (``pipelines/base.py BasePipeline.denoise``), the
CLI's own path. Traffic, pool and check are ``denoise.py``'s.

Set-up builds what the CLI's placement (``parallel/placement.py
place_dit(offload=True)``) holds, without the whole DiT ever on the card:
the resident part (embeddings, head, their norms) from the seed in bf16,
then each block from the seed one at a time (``inputs.group_maker``'s
"blocks.<i>." group), cast into pinned host memory by the program's own
``offload_blocks_to_host``; ``StreamedDiT`` wraps them as
``scripts/infer.py load_models`` does.

``correct``: ``denoise.py``'s, against the plain fp32 reference with its
weights rounded as the streamed configuration stores them
(``reference/stream.py``).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from h100_bench import inputs
from h100_bench.drivers import denoise
from h100_bench.reference import dit as ref_dit
from h100_bench.reference import stream as ref_stream


class _SeededBlocks(Sequence):
    """The blocks' state dicts, each made from the seed when it is asked
    for, in the order of a block's own state dict."""

    def __init__(self, make, count, order):
        self.make, self.count, self.order = make, count, order

    def __len__(self):
        return self.count

    def __getitem__(self, i):
        if not 0 <= i < self.count:
            raise IndexError(i)
        made = self.make(f"blocks.{i}.")
        if set(made) != set(self.order):
            raise ValueError(f"block {i}: the spec and the program's block "
                             f"differ: {sorted(set(made) ^ set(self.order))}")
        return {k: made[k] for k in self.order}


@torch.no_grad()
def build_streamed(cfg, seed, device):
    """(resident ``WanDiT`` in bf16 on ``device``, its blocks in host
    memory as the CLI's ``--offload_blocks`` stores them, pinned on the
    card), every tensor from the seed."""
    from more4d_tpu_torch.models.wan_dit import WanDiT
    from more4d_tpu_torch.parallel.offload import (offload_blocks_to_host,
                                                   split_block_params)

    with torch.device("meta"):
        dit = WanDiT(denoise.dit_config(cfg))
    order = list(dit.blocks[0].state_dict())
    resident, _ = split_block_params(dit)
    resident = resident.to(torch.bfloat16).to_empty(device=device)
    make, _ = inputs.group_maker(cfg, seed, torch.bfloat16, device)
    top = make("")
    params = dict(resident.named_parameters())
    if set(top) != set(params):
        raise ValueError(f"the resident part and the spec differ: "
                         f"{sorted(set(top) ^ set(params))[:5]}")
    for name, t in top.items():
        params[name].copy_(t)
    del top
    host = offload_blocks_to_host(
        _SeededBlocks(make, cfg["num_layers"], order), "fp8", device)
    return resident.eval(), host


class Session(denoise.Session):

    def _build(self):
        from more4d_tpu_torch.parallel.offload import StreamedDiT

        resident, host = build_streamed(self.cfg, self.seed, self.device)
        timed = self._pipeline(resident, self.steps)
        timed.streamed_dit = StreamedDiT(timed.dit, host, self.device,
                                         rope_tables=timed.rope_tables)
        del host
        # warm-up: every shape of the window in one sampler step, through a
        # pipeline over the same streamed DiT
        self.pipe = self._pipeline(resident, 1)
        self.pipe.streamed_dit = timed.streamed_dit
        self._request(self.pool[0])
        self.pipe = timed
        self._sync()

    def reference(self, slot: int, pr=ref_dit.FP32):
        """The reference's final latents of a request on pool slot
        ``slot``, computed in ``pr`` on the streamed storage's weights."""
        ref_dit.exact_fp32()
        return ref_dit.denoise(ref_stream.weights(self.cfg, self.seed,
                                                  self.device),
                               self.cfg, self.pool[slot], self.steps,
                               self.traffic["shift"],
                               self.traffic["guidance_scale"], pr)


def setup(cfg, traffic, seed, device, program=True):
    return Session(cfg, traffic, seed, device, program)
