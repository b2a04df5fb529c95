"""The attention forward's share of its roofline in the denoise steps:
the sum over a step's attention calls (per block the self-attention at
[2, L, H, 128] and the text and CLIP cross-attentions, CFG-doubled) of
max(FLOPs / bf16 peak, bytes / HBM peak), over the device time of the
kernels launched inside the benchmark's span around the DiT's attention
entry (``nn/attention.py flash_attention``), whatever their names."""

from h100_bench.yardstick.counts import (attention_calls, attn_fwd_work,
                                         bound_s)

SPAN = "h100_bench.attn"


def read(ctx):
    acts = [a for a in ctx.trace.attributed(SPAN) if a.kernel]
    if not acts or not ctx.trace_units:
        return None
    device_s = sum(a.end - a.start for a in acts) / 1e9
    bound = sum(bound_s(*attn_fwd_work(*c))
                for c in attention_calls(ctx.cfg, batch=2)) * ctx.trace_units
    return 100.0 * bound / device_s
