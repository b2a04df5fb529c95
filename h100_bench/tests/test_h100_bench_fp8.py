"""The reference's fp8 rounding and its rule of which tensors the 14B
configuration stores in fp8, held to torch's cast and to the program's
``quantize_params_fp8``."""

import torch

from h100_bench import inputs
from h100_bench.reference.fp8 import round_e4m3, scaled_e4m3, stored_in_fp8


def test_round_e4m3_is_the_cast_for_every_bf16_value():
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16).float()
    x = x[torch.isfinite(x) & (x.abs() <= 448)]
    want = x.to(torch.float8_e4m3fn).float()
    got = round_e4m3(x)
    assert torch.equal(got, want)


def test_round_e4m3_on_fp32_values_and_saturation():
    x = torch.randn(100_000, generator=torch.Generator().manual_seed(0)) * 30
    assert torch.equal(round_e4m3(x), x.to(torch.float8_e4m3fn).float())
    assert round_e4m3(torch.tensor([1000.0, -500.0])).tolist() == [448.0,
                                                                   -448.0]


def test_scaled_e4m3_keeps_the_largest_value():
    x = torch.tensor([0.001, -0.5, 0.25])
    assert scaled_e4m3(x)[1].item() == -0.5


def test_stored_in_fp8_is_the_programs_rule():
    from _tiny import TINY
    import json

    from h100_bench.drivers.denoise import build_dit
    from more4d_tpu_torch.parallel.placement import place_dit
    from h100_bench.harness import ROOT

    cfg = dict(json.loads((ROOT / "h100_bench/configs/more4d-14b-fp8.json")
                          .read_text()), **TINY)
    dit = build_dit(cfg, 3, torch.device("cpu"), torch.bfloat16)
    before = {n: p.detach().clone() for n, p in dit.named_parameters()}
    place_dit(dit, fp8=True, device="cpu")
    after = dict(dit.named_parameters())
    for name, p in after.items():
        assert (p.dtype == torch.float8_e4m3fn) == stored_in_fp8(name), name
        if stored_in_fp8(name):
            assert torch.equal(p.float(), round_e4m3(before[name].float()))
    names = {n for _, pre, spec in inputs.groups(cfg) for n in
             (pre + s[0] for s in spec)}
    assert names == set(after)
