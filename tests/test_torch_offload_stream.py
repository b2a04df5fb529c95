"""The DiT streamed from host memory (``parallel/offload.py StreamedDiT``,
``--offload_blocks``) as the benchmark's streamed cell runs it: the spans of
the walk, the benchmark reference's storage rule held to the program's,
and ``StreamedDiT.denoise`` held to that plain reference on seeded weights
at a tiny size on the CPU.

Tolerance: the streamed denoise against the fp32 reference on the same
fp8-rounded weights, ``latent_gap`` (||out - ref|| / ||ref - noise||) at
most 0.03: the program computes in bf16 (every product and kept value
rounded to 8 mantissa bits), which reads 0.016-0.018 here on three seeds.
The same reference with the weights left in bf16, or rounded by the
resident fp8 rule, reads 0.041-0.064: over the tolerance, so it tells the
storage rules apart.
"""

import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from h100_bench import compare, inputs  # noqa: E402
from h100_bench.drivers import denoise_stream  # noqa: E402
from h100_bench.reference import dit as ref_dit  # noqa: E402
from h100_bench.reference import stream as ref_stream  # noqa: E402
from h100_bench.reference.fp8 import round_e4m3, stored_in_fp8  # noqa: E402
from more4d_tpu_torch.parallel import offload  # noqa: E402
from more4d_tpu_torch.parallel.offload import (  # noqa: E402
    StreamedDiT, offload_blocks_to_host, split_block_params)
from more4d_tpu_torch.utils.quantize import FP8  # noqa: E402

from test_torch_spans import (_dit, _inputs, _names, _spans,  # noqa: E402
                              _streamed_denoise, DIT, STEPS)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# the benchmark's tiny widths (h100_bench/tests/_tiny.py), 3 blocks
TINY = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=3, text_len=8,
            text_dim=16, clip_dim=16, clip_tokens=5, motion_feature_dim=8,
            mpm_tokens=16, num_frames=5, height=32, width=32, freq_dim=16,
            sample_steps=3)
TOL = 0.03
SEEDS = (3, 2 ** 33 + 7)


def _cell():
    with open(os.path.join(ROOT, "h100_bench", "configs",
                           "more4d-14b-stream.json")) as f:
        cfg = dict(json.load(f), **TINY)
    with open(os.path.join(ROOT, "h100_bench", "traffic",
                           "more4d-14b-stream.straag_denoise.json")) as f:
        traffic = json.load(f)
    return cfg, traffic


def _streamed():
    """A tiny DiT's resident part and its StreamedDiT on the CPU."""
    resident, blocks = split_block_params(_dit())
    host = offload_blocks_to_host(blocks, "fp8", "cpu")
    return StreamedDiT(resident, host, "cpu")


def _forward(sd):
    x = _inputs(sd.cfg)
    return sd(x["x"], torch.full((1,), 500.0), x["context"], y=x["y"],
              clip_fea=x["clip_fea"], mpm_features=x["mpm_features"])


def test_the_streamed_walk_opens_the_backbone_and_a_fetch_per_block():
    sd = _streamed()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _forward(sd)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith("more4d.")),
                   key=lambda s: s[1])
    backbone = [(s, e) for n, s, e in spans if n == "more4d.dit.backbone"]
    fetches = [(s, e) for n, s, e in spans if n == "more4d.stream.fetch"]
    assert len(backbone) == 1
    assert len(fetches) == DIT["num_layers"]
    # each block's copy is issued inside the walk
    (b0, b1), = backbone
    assert all(b0 <= s and e <= b1 for s, e in fetches)


def test_a_streamed_request_names_each_phase_once_where_it_runs():
    names = _names(_spans(_streamed_denoise))
    assert names[0] == "more4d.denoise" and names.count("more4d.denoise") == 1
    for part in ("embed", "backbone", "finalize"):
        assert names.count(f"more4d.dit.{part}") == STEPS
    assert names.count("more4d.stream.fetch") == STEPS * DIT["num_layers"]


def test_the_streamed_walk_enters_no_span_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _streamed_denoise()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _streamed_denoise()
    assert "more4d.stream.fetch" in entered


def test_no_copy_is_counted_on_the_cpu():
    copies, nbytes = StreamedDiT.copies, StreamedDiT.copied_bytes
    _forward(_streamed())
    # nothing is copied on the CPU: each block runs on its host buffer
    assert (StreamedDiT.copies, StreamedDiT.copied_bytes) == (copies, nbytes)


@pytest.mark.parametrize("config", ["more4d-14b-stream", "tiny"])
def test_stored_streamed_is_the_programs_storage_rule(config):
    """Leaf by leaf, the reference's rule gives the dtype the program's
    ``offload_blocks_to_host`` stores (``offload._quantized_dtype``), at the
    14B's names and shapes and at the tiny ones; every tensor outside the
    blocks stays bf16 on the card."""
    cfg, _ = _cell()
    if config != "tiny":
        with open(os.path.join(ROOT, "h100_bench", "configs",
                               f"{config}.json")) as f:
            cfg = json.load(f)
    with torch.device("meta"):
        from more4d_tpu_torch.models.wan_dit import WanDiT

        dit = WanDiT(denoise_stream.denoise.dit_config(cfg))
    block = dit.blocks[0].state_dict()
    spec = {n: s for n, s, _, _ in inputs.block_spec(cfg)}
    assert set(block) == set(spec)
    for name, t in block.items():
        want = offload._quantized_dtype("fp8", name, tuple(t.shape),
                                        torch.bfloat16)
        got = FP8 if ref_stream.stored_streamed("blocks.7." + name) \
            else torch.bfloat16
        assert got == want, name
    for name, _, _, _ in inputs.top_spec(cfg):
        assert not ref_stream.stored_streamed(name), name
    if config == "tiny":
        # the dtypes the program's host buffers hold
        resident, host = denoise_stream.build_streamed(cfg, 5, "cpu")
        for name, t in host[1].tensors.items():
            assert (t.dtype == FP8) == ref_stream.stored_streamed(
                "blocks.1." + name), name
        assert all(p.dtype == torch.bfloat16 for p in resident.parameters())


@pytest.mark.parametrize("seed", SEEDS)
def test_streamed_denoise_agrees_with_the_plain_reference(seed, monkeypatch):
    cfg, traffic = _cell()
    walks = []
    walk = StreamedDiT.backbone

    def counted(self, it):
        walks.append(len(self.host_blocks))
        return walk(self, it)
    monkeypatch.setattr(StreamedDiT, "backbone", counted)
    sess = denoise_stream.setup(cfg, traffic, seed, torch.device("cpu"))
    walks.clear()
    req = sess.pool[1]
    out = sess._request(req)
    # the request ran StreamedDiT's loop: one walk of every block a step
    assert walks == [cfg["num_layers"]] * cfg["sample_steps"]
    ref_dit.exact_fp32()

    def reference(weights):
        return ref_dit.denoise(weights, cfg, req, cfg["sample_steps"],
                               traffic["shift"], traffic["guidance_scale"])

    gap = compare.latent_gap(out, reference(
        ref_stream.weights(cfg, seed, "cpu")), req["x"])
    assert gap <= TOL
    # the reference's rounding is what the program stores: bf16 weights,
    # or the resident fp8 rule, read wider than the tolerance
    for rule in (lambda n: False, stored_in_fp8):
        other = inputs.group_maker(
            cfg, seed, torch.bfloat16, "cpu",
            lambda n, v, r=rule: round_e4m3(v.float()) if r(n)
            else v.float())[0]
        assert compare.latent_gap(out, reference(other), req["x"]) > TOL
