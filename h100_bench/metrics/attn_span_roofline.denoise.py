"""The attention forward's share of its roofline in the denoise steps,
read under the program's own span: the bound of
``attn_fwd_roofline.denoise`` (the sum over a step's attention calls,
CFG-doubled, of max(FLOPs / bf16 peak, bytes / HBM peak)) over the device
time of the kernels launched inside ``more4d.attn`` (the port's
``kernels/flash_attention.py flash_attention`` without autograd),
whatever their names."""

from h100_bench.yardstick import spans
from h100_bench.yardstick.counts import (attention_calls, attn_fwd_work,
                                         bound_s)


def read(ctx):
    acts = spans.launched(ctx.trace, spans.ATTN)
    acts = [a for a in acts or () if a.kernel]
    if not acts or not ctx.trace_units:
        return None
    device_s = sum(a.end - a.start for a in acts) / 1e9
    bound = sum(bound_s(*attn_fwd_work(*c))
                for c in attention_calls(ctx.cfg, batch=2)) * ctx.trace_units
    return 100.0 * bound / device_s
