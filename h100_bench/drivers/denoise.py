"""Closed-loop denoising, one client: each request is one
``WanControlPipeline.denoise`` (``pipelines/base.py BasePipeline.denoise``)
of ``sample_steps`` CFG-doubled flow-match Euler steps from its noise,
TeaCache off. Requests cycle through a pool made in set-up from the seed
(noise, y, text and negative-text embeddings, CLIP and MPM features).

``correct``: once the window has closed, the requests of one pool slot
drawn from the seed are held to the plain fp32 reference run once on that
slot's inputs (``latent_gap``).
"""

from __future__ import annotations

import random

import torch

from h100_bench import compare, inputs
from h100_bench.reference import dit as ref_dit
from h100_bench.reference.fp8 import round_e4m3, stored_in_fp8

POOL_TAG = 100


def dit_config(cfg, **kw):
    from more4d_tpu_torch.config import DiTConfig

    fields = {f: cfg[f] for f in DiTConfig.__dataclass_fields__ if f in cfg}
    fields["patch_size"] = tuple(fields["patch_size"])
    fields.update(kw)
    return DiTConfig(**fields)


def build_dit(cfg, seed, device, storage, **kw):
    """The port's ``WanDiT`` built on the meta device, allocated on
    ``device`` in ``storage`` and filled from the seed."""
    from more4d_tpu_torch.models.wan_dit import WanDiT

    dcfg = dit_config(cfg, **kw)
    with torch.device("meta"):
        dit = WanDiT(dcfg)
    dit = dit.to(storage).to_empty(device=device)
    inputs.fill_module(dit, cfg, seed)
    return dit


class _NoVAE(torch.nn.Module):
    """The pipeline holds a VAE; the denoise loop never calls it, so it is
    not resident (its configuration alone sets the latent grid)."""

    def __init__(self):
        super().__init__()
        from more4d_tpu_torch.config import VAEConfig

        self.cfg = VAEConfig()


def reference_weights(cfg, seed, device):
    """The reference's fp32 weights, made again from the seed a group at a
    time, in the configuration's storage: bf16, with the fp8 rule applied
    where the configuration stores weights in fp8."""
    fp8 = cfg.get("fp8_weights", False)

    def stored(name, v):
        return round_e4m3(v.float()) if fp8 and stored_in_fp8(name) \
            else v.float()
    return inputs.group_maker(cfg, seed, torch.bfloat16, device, stored)[0]


class Session:
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, program=True):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.steps = cfg["sample_steps"]
        self.pool = [inputs.conditioning(cfg, seed, POOL_TAG + j, device)
                     for j in range(traffic["pool"])]
        self.outputs = {}
        self.attempted = 0
        self.failed = 0
        self.pipe = None
        if program:
            self._build()

    def _pipeline(self, dit, steps):
        from more4d_tpu_torch.config import PipelineConfig
        from more4d_tpu_torch.pipelines import WanControlPipeline

        cfg, traffic = self.cfg, self.traffic
        return WanControlPipeline(
            dit, _NoVAE(), PipelineConfig(
                num_inference_steps=steps,
                guidance_scale=traffic["guidance_scale"],
                shift=traffic["shift"], num_frames=cfg["num_frames"],
                height=cfg["height"], width=cfg["width"],
                cfg_skip_ratio=traffic["cfg_skip_ratio"]),
            device=self.device, teacache=None)

    def _build(self):
        dit = build_dit(self.cfg, self.seed, self.device, torch.bfloat16)
        if self.cfg.get("fp8_weights"):
            from more4d_tpu_torch.parallel.placement import place_dit

            place_dit(dit, fp8=True, device=self.device)
        # warm-up: every shape of the window in one sampler step (each step
        # of a request runs the same ones), through a pipeline over the same
        # DiT; the timed pipeline is built after it
        self.pipe = self._pipeline(dit, 1)
        self._request(self.pool[0])
        self.pipe = self._pipeline(dit, self.steps)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _request(self, req):
        return self.pipe.denoise(req["x"], req["context"], req["neg_context"],
                                 y=req["y"], clip_fea=req["clip_fea"],
                                 mpm_features=req["mpm_features"])

    def run_one(self) -> int:
        """One request; returns the sampler steps it completed."""
        i = self.attempted
        self.attempted += 1
        out = self._request(self.pool[i % len(self.pool)])
        self._sync()
        self.outputs[i] = out
        return self.steps

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"denoise_step_s": window_s / units}

    def release(self):
        """Free the program's state (the DiT and the pipeline)."""
        self.pipe = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, slot: int, pr=ref_dit.FP32):
        """The reference's final latents of a request on pool slot
        ``slot``, computed in ``pr``."""
        ref_dit.exact_fp32()
        return ref_dit.denoise(reference_weights(self.cfg, self.seed,
                                                 self.device),
                               self.cfg, self.pool[slot], self.steps,
                               self.traffic["shift"],
                               self.traffic["guidance_scale"], pr)

    def judge(self, outs, ref, slot):
        """[(name, value, limit)] of the final latents ``outs`` of requests
        on pool slot ``slot`` against the reference's ``ref``."""
        start = self.pool[slot]["x"]
        gap = max(compare.latent_gap(o, ref, start) for o in outs)
        return [("latent_gap", gap, self.traffic["limits"]["latent_gap"])]

    def verify(self):
        """[(name, value, limit)]: the requests of one pool slot, drawn from
        the seed, against the reference on that slot's inputs."""
        done = sorted(self.outputs)
        self.failed = sum(not torch.isfinite(self.outputs[i]).all().item()
                          for i in done)
        slots = sorted({i % len(self.pool) for i in done})
        slot = random.Random(self.seed).choice(slots)
        outs = [self.outputs[i] for i in done if i % len(self.pool) == slot]
        return self.judge(outs, self.reference(slot), slot)

    def controls(self, precisions):
        """{name: [(name, value, limit)]}: the reference computed in each of
        ``precisions`` put in the program's place, judged as the program's
        requests are."""
        ref = self.reference(0)
        return {name: self.judge([self.reference(0, pr)], ref, 0)
                for name, pr in precisions.items()}


def setup(cfg, traffic, seed, device, program=True):
    return Session(cfg, traffic, seed, device, program)
