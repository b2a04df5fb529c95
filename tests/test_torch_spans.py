"""The port's spans (``utils/profiling.py span``): nothing entered while no
profiler records, and under one each phase of a denoise request (resident
or with its blocks streamed from host memory), of a train step and of a
streamed LoRA step named once where it runs, by the names ``SPANS``
lists."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from more4d_tpu_torch.config import PipelineConfig, VAEConfig, dit_tiny
from more4d_tpu_torch.models import WanDiT
from more4d_tpu_torch.pipelines import WanControlPipeline
from more4d_tpu_torch.train import StraagTrainConfig, make_adamw, train_step
from more4d_tpu_torch.train.train_straag import straag_update
from more4d_tpu_torch.utils import profiling

DIT = dict(in_dim=16, out_dim=4, dim=32, ffn_dim=64, num_heads=2,
           num_layers=2, text_dim=16, clip_dim=16, text_len=8,
           motion_guidance=True, model_type="i2v")
B, LT, LH, LW = 1, 2, 4, 4
STEPS = 2
TRAIN = ("more4d.train.forward", "more4d.train.backward",
         "more4d.train.clamp", "more4d.train.optimizer", "more4d.train.ema")


class _NoVAE(torch.nn.Module):
    """The denoise loop never calls the VAE."""

    def __init__(self):
        super().__init__()
        self.cfg = VAEConfig()


def _dit():
    torch.manual_seed(0)
    dit = WanDiT(dit_tiny(dtype=torch.float32, **DIT))
    with torch.no_grad():
        for p in dit.parameters():
            p.normal_(0.0, 0.04)
    return dit


def _inputs(cfg, batch=B):
    g = torch.Generator().manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, generator=g)
    return {"x": rand(batch, LT, LH, LW, 4),
            "y": rand(batch, LT, LH, LW, 12),
            "context": rand(batch, 8, 16), "neg": rand(batch, 8, 16),
            "clip_fea": rand(batch, cfg.clip_tokens, 16),
            "mpm_features": rand(batch, 196, cfg.motion_feature_dim)}


def _denoise():
    """One request of STEPS CFG-doubled steps through a tiny pipeline."""
    dit = _dit()
    pipe = WanControlPipeline(dit, _NoVAE(), PipelineConfig(
        num_inference_steps=STEPS, guidance_scale=5.0, shift=3.0),
        device="cpu")
    x = _inputs(dit.cfg)
    return pipe.denoise(x["x"], x["context"], x["neg"], y=x["y"],
                        clip_fea=x["clip_fea"],
                        mpm_features=x["mpm_features"])


def _streamed_denoise():
    """The request of ``_denoise`` with the DiT's blocks streamed from host
    memory (``--offload_blocks``): the loop runs in ``StreamedDiT``."""
    from more4d_tpu_torch.parallel.offload import (StreamedDiT,
                                                   offload_blocks_to_host,
                                                   split_block_params)

    resident, blocks = split_block_params(_dit())
    host = offload_blocks_to_host(blocks, "fp8", "cpu")
    pipe = WanControlPipeline(resident, _NoVAE(), PipelineConfig(
        num_inference_steps=STEPS, guidance_scale=5.0, shift=3.0),
        device="cpu")
    pipe.streamed_dit = StreamedDiT(resident, host, "cpu",
                                    rope_tables=pipe.rope_tables)
    x = _inputs(resident.cfg)
    return pipe.denoise(x["x"], x["context"], x["neg"], y=x["y"],
                        clip_fea=x["clip_fea"],
                        mpm_features=x["mpm_features"])


def _train(steps=STEPS):
    """``steps`` train steps of a tiny DiT, every weight trainable."""
    dit = _dit()
    dit.train()
    named = list(dit.named_parameters())
    opt, _ = make_adamw(named, 1e-4)
    tcfg = StraagTrainConfig(learning_rate=1e-4)
    update = straag_update([p for _, p in named], opt, tcfg)
    ema = {n: p.detach().clone() for n, p in named}
    x = _inputs(dit.cfg)
    batch = {"latents": x["x"], "y": x["y"], "context": x["context"],
             "clip_fea": x["clip_fea"], "mpm_features": x["mpm_features"]}
    out = []
    for step in range(steps):
        idx = torch.tensor([100 + 300 * step])
        noise = torch.randn(x["x"].shape,
                            generator=torch.Generator().manual_seed(step))
        out.append(train_step(dit, update, ema, tcfg, batch, idx, noise,
                              step))
    return out


def _lora_steps(steps=STEPS):
    """``steps`` LoRA steps of the tiny DiT with its blocks streamed from
    host memory (``--offload_blocks``), the factors' up drawn so that
    the side path acts."""
    from more4d_tpu_torch.train.lora_streamed import \
        make_streamed_lora_trainer
    from more4d_tpu_torch.train.optim import GradUpdate
    from more4d_tpu_torch.train.train_vism import (VismTrainConfig,
                                                   factor_leaves)

    g = torch.Generator().manual_seed(2)
    trainer, lora = make_streamed_lora_trainer(
        _dit().requires_grad_(False), VismTrainConfig(), g, rank=2,
        alpha=2.0, quantize="fp8", device="cpu")
    for f in lora["factors"].values():
        f["up"].normal_(0.0, 0.05, generator=g)
    leaves = factor_leaves(lora)
    update = GradUpdate(leaves, torch.optim.SGD(leaves, lr=0.1))
    x = _inputs(trainer.cfg)
    batch = {"latents": x["x"], "y": x["y"], "context": x["context"],
             "clip_fea": x["clip_fea"], "mpm_features": x["mpm_features"]}
    return [trainer.train_step(lora, update, batch,
                               torch.tensor([100 + 300 * step]),
                               torch.randn(x["x"].shape, generator=g))
            for step in range(steps)]


def _spans(fn):
    """The ``more4d.*`` spans ``fn()`` emits under the profiler, as
    (name, start) in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start) for e in prof.events()
                   if e.name.startswith("more4d.")), key=lambda s: s[1])


def _names(spans):
    return [n for n, _ in spans]


@pytest.mark.parametrize("work", [_denoise, _train, _lora_steps])
def test_no_span_is_entered_without_a_profiler(work, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    work()
    assert entered == []
    # the same work under a profiler enters the counted function: the
    # count above would have seen a span
    with profile(activities=[ProfilerActivity.CPU]):
        work()
    assert any(n.startswith("more4d.") for n in entered)


def test_a_denoise_request_names_each_phase_once_where_it_runs():
    names = _names(_spans(_denoise))
    assert names.count("more4d.denoise") == 1
    assert names[0] == "more4d.denoise"
    for part in ("embed", "backbone", "finalize"):
        assert names.count(f"more4d.dit.{part}") == STEPS
    # self, text and CLIP attention, a block a step
    assert names.count("more4d.attn") == 3 * DIT["num_layers"] * STEPS
    assert not any(n.startswith("more4d.train.") for n in names)


def test_an_attention_over_no_keys_launches_nothing_and_has_no_span():
    from more4d_tpu_torch.kernels.flash_attention import flash_attention

    q = torch.randn(1, 4, 2, 8)
    empty = torch.randn(1, 0, 2, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flash_attention(q, empty, empty)
        flash_attention(q, q, q)
    assert [e.name for e in prof.events()
            if e.name.startswith("more4d.")] == ["more4d.attn"]


def test_a_train_step_names_its_phases_once_a_step_in_order():
    names = _names(_spans(_train))
    # with a gradient the attention runs as the op, under its own name
    assert "more4d.attn" not in names
    assert [n for n in names if n.startswith("more4d.train.")] == \
        list(TRAIN) * STEPS
    for part in ("embed", "backbone", "finalize"):
        assert names.count(f"more4d.dit.{part}") == STEPS


def test_the_phases_nest_as_the_metrics_read_them():
    spans = _spans(_train)
    # every DiT span of a step lies inside that step's forward: the
    # backward's remat recompute runs the blocks, not the DiT's methods
    forwards = [t for n, t in spans if n == "more4d.train.forward"]
    backwards = [t for n, t in spans if n == "more4d.train.backward"]
    for n, t in spans:
        if n.startswith("more4d.dit."):
            assert any(f <= t < b for f, b in zip(forwards, backwards))


def test_a_skipped_step_has_no_ema_span():
    def skipped():
        dit = _dit()
        named = list(dit.named_parameters())
        opt, _ = make_adamw(named, 1e-4)
        # every loss counts as abnormal from step 0 on
        tcfg = StraagTrainConfig(learning_rate=1e-4,
                                 abnormal_loss_threshold=0.0,
                                 abnormal_loss_start_step=0)
        update = straag_update([p for _, p in named], opt, tcfg)
        ema = {n: p.detach().clone() for n, p in named}
        x = _inputs(dit.cfg)
        m = train_step(dit, update, ema, tcfg,
                       {"latents": x["x"], "y": x["y"],
                        "context": x["context"], "clip_fea": x["clip_fea"],
                        "mpm_features": x["mpm_features"]},
                       torch.tensor([500]), torch.randn(x["x"].shape), 1)
        assert m["skipped"] and not m["updated"]
        assert all(p.grad is None for _, p in named)
    names = [n for n in _names(_spans(skipped))
             if n.startswith("more4d.train.")]
    assert names == list(TRAIN[:4])


def test_every_span_emitted_is_listed_and_every_listed_one_emitted():
    emitted = set(_names(_spans(_denoise))) | set(_names(_spans(_train))) \
        | set(_names(_spans(_streamed_denoise))) \
        | set(_names(_spans(_lora_steps)))
    assert emitted == set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))
