"""The fp8 -> bf16 widening of the port's fp8 weights (``kernels/widen.py``,
``nn.layers.compute_param``) on the CPU, where K6 never runs:

- ``widen_fp8_plain`` gives the bits the widening gave before K6 existed
  (``_old_compute_param``, kept here as written), for all 256 e4m3 codes
  (+-0, subnormals, +-448, the two NaNs), unscaled and scaled, to bf16 and
  fp32; the unscaled values are the codes' exact values (an e4m3 decoder
  of the bits written out here);
- ``compute_param`` on the CPU takes the plain path, with the same bits,
  for weights that are views at odd offsets into a flat byte buffer;
- a bf16 or fp32 parameter never reaches K6's dispatcher, which routes
  every tensor on the host to the plain version; an fp8 DiT widens each of
  its fp8 tensors once a forward, resident and streamed (the count
  ``chip_smoke.py`` holds K6's launches to on the card).

Tolerance 0 throughout. The card's side is in
``tests/test_torch_kernels_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from more4d_tpu_torch.config import dit_tiny
from more4d_tpu_torch.kernels import widen
from more4d_tpu_torch.models.wan_dit import WanDiT
from more4d_tpu_torch.nn import layers
from more4d_tpu_torch.nn.layers import Linear, compute_param
from more4d_tpu_torch.parallel.offload import (StreamedDiT,
                                               offload_blocks_to_host,
                                               split_block_params)
from more4d_tpu_torch.utils.quantize import FP8, quantize_params_fp8

SCALES = [None, 1.0, 0.0123, 3.0e-3, 1.0 / 448, 7.25]
CODES = torch.arange(256, dtype=torch.int32).to(torch.uint8)


def _old_compute_param(module, name, dtype):
    """``compute_param`` as it read before K6."""
    p = getattr(module, name)
    if p.dtype == torch.float8_e4m3fn:
        scale = getattr(module, name + "_scale", None)
        if scale is not None:
            p = (p.float() * scale).to(torch.bfloat16)
    return p.to(dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bit patterns of a bf16 (int16) or fp32 (int32) tensor."""
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return t.contiguous().view(as_int[t.dtype]).numpy()


def _e4m3(code: int) -> float:
    """The value of an e4m3fn code: 1 sign, 4 exponent (bias 7) and 3
    mantissa bits, no infinities, S.1111.111 NaN."""
    sign = -1.0 if code & 0x80 else 1.0
    exp, man = (code >> 3) & 0xF, code & 0x7
    if exp == 0xF and man == 0x7:
        return math.nan
    if exp == 0:
        return sign * man * 2.0 ** -9
    return sign * (1 + man / 8) * 2.0 ** (exp - 7)


def _scale(value):
    return None if value is None else torch.tensor(value, dtype=torch.float32)


def _linear_with(weight: torch.Tensor, scale=None) -> Linear:
    out_f, in_f = weight.shape
    lin = Linear(in_f, out_f, torch.bfloat16, bias=False)
    lin.weight = torch.nn.Parameter(weight, requires_grad=False)
    if scale is not None:
        lin.register_buffer("weight_scale", scale)
    return lin


@pytest.fixture
def no_k6(monkeypatch):
    """K6 made to fail loudly if anything launches it."""
    def refuse(*a, **k):
        raise AssertionError("K6 launched on the CPU")

    monkeypatch.setattr(widen, "widen_fp8_cuda", refuse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("scale", SCALES, ids=[str(s) for s in SCALES])
def test_plain_widening_keeps_the_old_bits_for_every_code(scale, dtype):
    codes = CODES.view(FP8)
    lin = _linear_with(codes.reshape(16, 16), _scale(scale))
    want = _old_compute_param(lin, "weight", dtype)
    got = widen.widen_fp8_plain(codes, dtype, _scale(scale)).reshape(16, 16)
    assert got.dtype == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_unscaled_widening_gives_each_codes_exact_value():
    got = widen.widen_fp8_plain(CODES.view(FP8), torch.bfloat16).float()
    values = [_e4m3(c) for c in range(256)]
    nan = np.isnan(values)
    assert nan.sum() == 2 and nan[0x7F] and nan[0xFF]
    assert torch.isnan(got[torch.from_numpy(nan)]).all()
    finite = got[torch.from_numpy(~nan)].double().numpy()
    np.testing.assert_array_equal(finite, np.asarray(values)[~nan])
    # the signs of the zeros, the subnormals' end and the largest normals
    assert _bits(got[[0x00, 0x80]].bfloat16()).tolist() == [0, -32768]
    assert got[0x01].item() == 2.0 ** -9 and got[0x07].item() == 7 * 2.0 ** -9
    assert got[0x7E].item() == 448.0 and got[0xFE].item() == -448.0


@pytest.mark.parametrize("offset", [0, 1, 3, 7, 8, 15, 256, 257])
@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
def test_compute_param_on_the_cpu_is_the_old_widening(no_k6, offset,
                                                      scaled):
    """Weights as views at any offset into one flat byte buffer (the
    streamed blocks' layout puts them at 256-byte offsets), of lengths
    that are not multiples of 16."""
    g = torch.Generator().manual_seed(offset)
    flat = torch.randint(0, 256, (offset + 37 * 29 + 5,), generator=g,
                         dtype=torch.int32).to(torch.uint8)
    view = flat[offset:offset + 37 * 29].view(FP8).view(37, 29)
    assert view.storage_offset() == offset
    scale = _scale(0.0311) if scaled else None
    lin = _linear_with(view, scale)
    for dtype in (torch.bfloat16, torch.float32):
        np.testing.assert_array_equal(
            _bits(compute_param(lin, "weight", dtype)),
            _bits(_old_compute_param(lin, "weight", dtype)))
    x = torch.randn(3, 29, generator=g).bfloat16()
    ref = torch.nn.functional.linear(
        x, _old_compute_param(lin, "weight", torch.bfloat16))
    np.testing.assert_array_equal(_bits(lin(x)), _bits(ref))


TINY = dict(motion_guidance=True, model_type="i2v", num_layers=2,
            text_len=24, clip_tokens=9)


def _tiny_dit(dtype):
    cfg = dit_tiny(dtype=dtype, param_dtype=dtype, **TINY)
    torch.manual_seed(0)
    model = WanDiT(cfg).to(dtype).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    return model


def _forward(model, dtype):
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    with torch.no_grad():
        return model(r(1, 3, 8, 8, 16), torch.full((1,), 500.0),
                     r(1, cfg.text_len, cfg.text_dim),
                     y=r(1, 3, 8, 8, cfg.in_dim - 16),
                     clip_fea=r(1, cfg.clip_tokens, cfg.clip_dim),
                     mpm_features=r(1, 16, cfg.motion_feature_dim))


@pytest.fixture
def widen_calls(monkeypatch):
    """Every call of K6's dispatcher from ``compute_param``, by the dtype
    it was handed."""
    calls = []
    dispatch = layers.widen_fp8

    def spy(p, dtype, scale=None):
        calls.append(p.dtype)
        return dispatch(p, dtype, scale)

    monkeypatch.setattr(layers, "widen_fp8", spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_bf16_and_fp32_params_never_reach_k6(no_k6, widen_calls, dtype):
    model = _tiny_dit(dtype)
    _forward(model, dtype)
    assert widen_calls == []


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "scaled"])
def test_an_fp8_dit_widens_each_fp8_tensor_once_a_forward(no_k6, widen_calls,
                                                          scaled):
    model = quantize_params_fp8(_tiny_dit(torch.bfloat16), scaled=scaled)
    n_fp8 = sum(p.dtype == FP8 for p in model.parameters())
    assert n_fp8 > 30
    _forward(model, torch.bfloat16)
    assert widen_calls == [FP8] * n_fp8


def test_a_streamed_dit_widens_each_blocks_fp8_matrices_once(no_k6,
                                                             widen_calls):
    model = _tiny_dit(torch.bfloat16)
    resident, blocks = split_block_params(model)
    host = offload_blocks_to_host(blocks, "fp8", "cpu")
    per_block = sum(v.dtype == FP8 for v in host[0].tensors.values())
    assert per_block == 14
    sd = StreamedDiT(resident, host, "cpu")
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g).bfloat16()

    with torch.no_grad():
        sd(r(1, 3, 8, 8, 16), torch.full((1,), 500.0),
           r(1, cfg.text_len, cfg.text_dim), y=r(1, 3, 8, 8, cfg.in_dim - 16),
           clip_fea=r(1, cfg.clip_tokens, cfg.clip_dim),
           mpm_features=r(1, 16, cfg.motion_feature_dim))
    assert widen_calls == [FP8] * (per_block * cfg.num_layers)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, FP8],
                         ids=["bf16", "fp32", "fp8"])
def test_k6_takes_no_cpu_tensor(no_k6, dtype):
    """The dispatcher routes by where the tensor lives: on the host, the
    plain version for every target and scale."""
    p = CODES.view(FP8).reshape(16, 16).to(dtype)
    for target in (torch.bfloat16, torch.float32):
        for scale in (None, _scale(0.5)):
            np.testing.assert_array_equal(
                _bits(widen.widen_fp8(p, target, scale)),
                _bits(widen.widen_fp8_plain(p, target, scale)))


@pytest.mark.parametrize("case", ["cpu_tensor", "fp32_target", "bf16_input",
                                  "strided", "fp16_target", "grad"])
def test_k6_refuses_what_it_cannot_take(case):
    p = CODES.view(FP8).reshape(16, 16)
    args = {"cpu_tensor": (p, torch.bfloat16),
            "fp32_target": (p, torch.float32),
            "bf16_input": (p.bfloat16(), torch.bfloat16),
            "strided": (p.t(), torch.bfloat16),
            "fp16_target": (p, torch.float16),
            "grad": (p.clone().requires_grad_(True), torch.bfloat16)}[case]
    with pytest.raises(ValueError, match="widen_fp8_cuda"):
        widen.widen_fp8_cuda(*args)
