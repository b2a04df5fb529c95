"""The frozen counts held to numbers worked out by hand."""

import json
from pathlib import Path

import pytest

from h100_bench.yardstick import counts, kinds

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "h100_bench" / "configs" / f"{name}.json")
                      .read_text())


def test_forward_flops_at_a_tiny_config_by_hand():
    from _tiny import TINY

    cfg = dict(_cfg("more4d-1.3b"), **TINY)
    # tokens: 2 latent frames x (32/8/2)^2 = 8; context 8 + 5 keys
    assert counts.num_tokens(cfg) == 8
    per_block = (4 * 2 * 8 * 64 * 64 + 2 * 2 * 8 * 8 * 64
                 + 2 * 2 * 8 * 64 * 64 + 2 * 2 * 13 * 64 * 64
                 + 2 * 2 * 8 * 13 * 64 + 2 * 2 * 8 * 64 * 128
                 + 2 * (2 * 8 * 8 * 2 * 64))
    assert per_block == 944_128
    total = 2 * per_block + 2 * 8 * 64 * 4 * 64 + 2 * 8 * 64 * 16 * 4 \
        + 2 * 8 * 16 * 64
    assert total == 2_232_320
    assert counts.dit_forward_flops(cfg, 8) == total
    assert counts.dit_forward_flops(cfg, 8, batch=2) == 2 * total


def test_forward_flops_at_the_operating_points():
    c13, c14 = _cfg("more4d-1.3b"), _cfg("more4d-14b-fp8")
    assert counts.num_tokens(c13) == 9568 == counts.num_tokens(c14)
    assert counts.dit_forward_flops(c13, 9568) == pytest.approx(4.5101e13,
                                                                rel=1e-4)
    assert counts.dit_forward_flops(c14, 9568) == pytest.approx(3.251e14,
                                                                rel=1e-3)


def test_attention_bounds_at_the_1_3b_step():
    # self-attention [2, 9568, 12, 128]: 4 x 2 x 12 x 9568^2 x 128 FLOPs at
    # 989 TFLOP/s is 1.137 ms; the text (512 keys) cross-attention 0.061 ms
    # of FLOPs; the CLIP one (257 keys) is bound by its 2 x 9568 x 12 x 128
    # x 2 bytes of q and o and its k, v: 0.036 ms at 3.35 TB/s
    sa = counts.bound_s(*counts.attn_fwd_work(2, 12, 9568, 9568, 128))
    assert sa == pytest.approx(4 * 2 * 12 * 9568 ** 2 * 128 / 989e12)
    assert sa * 1e3 == pytest.approx(1.137, abs=1e-3)
    txt = counts.bound_s(*counts.attn_fwd_work(2, 12, 9568, 512, 128))
    assert txt * 1e3 == pytest.approx(0.0609, abs=1e-4)
    clip_flops, clip_bytes = counts.attn_fwd_work(2, 12, 9568, 257, 128)
    assert clip_bytes == 2 * 2 * 12 * 128 * (2 * 9568 + 2 * 257) \
        + 4 * 2 * 12 * 9568
    assert counts.bound_s(clip_flops, clip_bytes) == clip_bytes / 3.35e12
    cfg = _cfg("more4d-1.3b")
    calls = counts.attention_calls(cfg, batch=2)
    assert len(calls) == 90
    step = sum(counts.bound_s(*counts.attn_fwd_work(*c)) for c in calls)
    assert step * 1e3 == pytest.approx(30 * (1.137 + 0.061 + 0.036),
                                       rel=5e-3)


def test_attention_backward_counts_five_products():
    f, b = counts.attn_bwd_work(1, 12, 9568, 9568, 128)
    assert f == 2.5 * counts.attn_fwd_work(1, 12, 9568, 9568, 128)[0]
    # q, o, dO, dq: 4 x Lq rows; k, v, dk, dv: 4 x Lk rows; lse read
    assert b == 2 * 12 * 128 * 4 * (9568 + 9568) + 4 * 12 * 9568


@pytest.mark.parametrize("name,kind", [
    ("void flash_fwd_kernel<128>(Params)", "K1 flash_attention"),
    ("void flash_bwd_dq_kernel<128>(P)", "K2 flash_attention_bwd_dq"),
    ("void dkv_reduce_kernel(float*)", "K3 flash_attention_bwd_dkv"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
     "TensorListMetadata<4>, FusedAdamMathFunctor>", kinds.FOREACH),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64",
     kinds.MATMUL),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", kinds.MATMUL),
    ("void at::native::reduce_kernel<512, 1, ReduceOp<float>>",
     kinds.REDUCTIONS),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>",
     kinds.COPIES),
    ("void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernel>",
     kinds.ELEMENTWISE),
    ("Memcpy HtoD (Pinned -> Device)", kinds.HOST_COPIES),
])
def test_kinds_table(name, kind):
    assert kinds.kind(name) == kind
