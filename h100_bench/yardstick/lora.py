"""Frozen arithmetic and trace reading of the LoRA fine-tune streamed
from host memory (``train/lora_streamed.py StreamedLoRATrainer``).

``step_flops`` counts one step's work at batch 1 by the conventions of
``counts.py`` (a multiply-add is 2 FLOPs; norms, activations and RoPE
left out): the forward (``dit_forward_flops``); the backward's own
work, which is dx through every frozen Linear whose input carries a
gradient (the self-attention's q, k, v, o, the cross-attention's q and
o, the FFN's two, the head; the cross-attention's k, v, k_img and v_img
read the context, which carries none), every attention call's backward
(``attn_bwd_work``: s again, dp, dq, dk, dv) and the LoRA side path
s (x down^T) up^T on every factored Linear, forward and backward. The
backward walk's recompute of each block is not counted, as ``mfu.train``
leaves out the remat; nor are weight gradients, which the frozen base
never takes.

The program's spans: the two walks, the side path and the launch of a
block copy (``utils/profiling.py``). A program without the walks' spans, as
the port was before it had them, leaves the readers with nothing to
read: each returns None then.
"""

from __future__ import annotations

import bisect
import math
from typing import List, Optional

from h100_bench.yardstick import kinds, spans
from h100_bench.yardstick.counts import (attention_calls, attn_bwd_work,
                                         dit_forward_flops, num_tokens)
from h100_bench.yardstick.trace import Activity, Trace

WALKS = ("more4d.lora.forward_walk", "more4d.lora.backward_walk")
SIDE = "more4d.lora.side"
FETCH = "more4d.stream.fetch"


def factored_linears(cfg):
    """(rows, in, out, whether the input carries a gradient) of each
    factored Linear of one block at batch 1."""
    d, f, lt = cfg["dim"], cfg["ffn_dim"], num_tokens(cfg)
    out = [(lt, d, d, True)] * 6                  # self q, k, v, o; cross q, o
    out += [(cfg["text_len"], d, d, False)] * 2   # cross k, v on the text
    if cfg["model_type"] == "i2v":                # cross k_img, v_img
        out += [(cfg["clip_tokens"], d, d, False)] * 2
    out += [(lt, d, f, True), (lt, f, d, True)]   # the FFN
    return out


def step_flops(cfg) -> float:
    """FLOPs of one LoRA step at batch 1 (see the module note)."""
    r, lt = cfg["lora_rank"], num_tokens(cfg)
    block = 0.0
    for m, n_in, n_out, dx in factored_linears(cfg):
        block += 2 * m * r * (n_in + n_out)       # the side path forward
        block += 2 * m * r * (2 * n_out + n_in)   # d(x down^T), d up, d down
        if dx:                                    # dx through W and down
            block += 2 * m * n_in * n_out + 2 * m * r * n_in
    attn_bwd = sum(attn_bwd_work(*c)[0] for c in attention_calls(cfg, 1))
    head = 2 * lt * cfg["dim"] * cfg["out_dim"] * math.prod(
        cfg["patch_size"])
    return (dit_forward_flops(cfg, lt, batch=1) + cfg["num_layers"] * block
            + attn_bwd + head)


def walk_copies(trace: Trace) -> Optional[List[Activity]]:
    """The host -> card copies in the window launched inside a
    ``more4d.stream.fetch`` span within one of the two walks: the block
    copies of a step. None where the window holds no walk span or no
    such copy."""
    walks = spans.union(trace, WALKS)
    if not walks:
        return None
    starts = [s for s, _ in walks]

    def in_walk(a):
        ts = trace.launch(a)[0]
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= walks[i][1]
    acts = [a for a in trace.attributed(FETCH)
            if kinds.kind(a.name) == kinds.HOST_COPIES and in_walk(a)]
    return acts or None
