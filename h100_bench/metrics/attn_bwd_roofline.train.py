"""The attention backward's share of its roofline in the train steps: the
sum over a step's attention calls at batch 1 of max(FLOPs / bf16 peak,
bytes / HBM peak) for the backward's work (s again, dp, dq, dk, dv), over
the device time of the kernels launched inside the autograd node of the
op ``more4d_torch::flash_attn`` (K2, K3, K3's reduce pass and the q' and
delta it forms), whatever their names."""

from h100_bench.yardstick.counts import (attention_calls, attn_bwd_work,
                                         bound_s)

OP = "more4d_torch::flash_attn"


def backward_node(name: str) -> bool:
    """The op's autograd node, as the profiler names its span
    (``GeneratedBackwardFor_more4d_torch_flash_attn_defaultBackward``,
    also under ``autograd::engine::evaluate_function: ...``)."""
    return OP.replace("::", "_") in name and name.endswith("Backward")


def read(ctx):
    acts = [a for a in ctx.trace.attributed(backward_node) if a.kernel]
    if not acts or not ctx.trace_units:
        return None
    device_s = sum(a.end - a.start for a in acts) / 1e9
    bound = sum(bound_s(*attn_bwd_work(*c))
                for c in attention_calls(ctx.cfg, batch=1)) * ctx.trace_units
    return 100.0 * bound / device_s
