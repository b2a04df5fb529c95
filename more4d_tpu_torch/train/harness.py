"""4D-STraG training harness on one device (PyTorch port of
``more4d_tpu/train/harness.py``): conditioning from the caller's encoders,
the frozen VAE encode, the train step (with gradient accumulation),
metrics with the per-parameter grad-norm report, validation sampling,
checkpoint and resume.

``prepare_batch`` assembles one batch:

- flow -> encoder adaptor -> *2-1 -> streamed VAE encode = the latents;
- control video and depth image -> streamed VAE encode;
- y = [control latents (2% dropout), zero ref slot, depth latents];
- per-sample text with 10% dropout to the empty prompt; CLIP features of
  the first RGB frame with 2% dropout to zeros; OmniMAE MPM patch tokens of
  the first frame.

Its dropouts come from a numpy ``RandomState(seed)`` drawn in the JAX
harness's order (full_ref keep, control keep, text dropout, CLIP keep), so
a seed gives the JAX package's dropouts. The timestep indices and the noise
come from a ``torch.Generator`` seeded alike (``train_straag.draw``).

Every ``validation_steps`` steps the ``validation_pipeline`` (a
``WanControlPipeline`` over the trained DiT) samples from the batch's
first sample and its prompt, and writes ``validation_<step>.gif``. Its
noise comes from a ``torch.Generator`` seeded with ``seed``, where JAX
uses ``PRNGKey(seed)``: the same seed gives other noise.

Not ported yet: the device mesh (FSDP and data parallelism). The trainer
trains the caller's DiT module in place. A checkpoint also carries both
generators' states and the accumulator, so a resumed run continues the
uninterrupted run's draws.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.sceneflow import SceneFlowSample
from ..models.vae_streaming import encode_streamed
from ..utils.metrics import MetricsLogger
from .checkpoint import CheckpointManager
from .train_straag import StraagTrainConfig, draw, straag_update, train_step


@dataclasses.dataclass
class StraagRunConfig:
    output_dir: str = "straag_ckpt"
    batch_size: int = 1
    max_steps: int = 10000
    checkpointing_steps: int = 500
    validation_steps: int = 0          # 0 = off
    log_steps: int = 50
    control_dropout: float = 0.02
    clip_dropout: float = 0.02
    text_dropout: float = 0.1
    seed: int = 42
    resume: bool = False
    checkpoints_total_limit: int = 2


def _numpy_state(rs: np.random.RandomState):
    """A RandomState's state with its key as a tensor, so that a checkpoint
    loads with ``torch.load(weights_only=True)``."""
    name, key, pos, has_gauss, gauss = rs.get_state()
    return (name, torch.from_numpy(key.astype(np.int64)), int(pos),
            int(has_gauss), float(gauss))


class StraagTrainer:
    """Wires the encoders, the frozen VAE and encoder adaptor, and the
    trainable DiT into the train step.

    ``optimizer`` (with its ``lr_scheduler``, see ``optim.make_adamw``)
    must be built on ``dit``'s trainable parameters; None gives the JAX
    harness's default, AdamW(learning_rate) with optax's defaults (eps
    1e-8, weight decay 1e-4). ``trainable_filter(name) -> bool`` freezes
    the parameters whose name it rejects. With ``tcfg.grad_accum_steps``
    > 1 the clamp moves onto the accumulated mean (``clip_in_tx``), as
    the JAX harness moves it into its MultiSteps chain.
    ``report_grad_norms`` logs each trainable parameter's gradient norm
    under ``grad_norm/`` on the log steps. ``split_step`` is JAX's
    two-jit step; the port's eager step is the same step with the skip
    decided on the host either way, so it changes nothing."""

    def __init__(self, dit, vae, encoder_adaptor,
                 encode_text: Callable[[Sequence[str]], torch.Tensor],
                 tcfg: StraagTrainConfig, run_cfg: StraagRunConfig,
                 encode_clip: Optional[Callable] = None,
                 extract_mpm: Optional[Callable] = None,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 lr_scheduler=None, validation_pipeline=None,
                 trainable_filter: Optional[Callable[[str], bool]] = None,
                 report_grad_norms: bool = False,
                 split_step: bool = False):
        if tcfg.grad_accum_steps > 1:
            tcfg = dataclasses.replace(tcfg, clip_in_tx=True)
        self.dit, self.vae, self.enc = dit, vae, encoder_adaptor
        self.encode_text = encode_text
        self.encode_clip = encode_clip
        self.extract_mpm = extract_mpm
        self.tcfg, self.run_cfg = tcfg, run_cfg
        self.validation_pipeline = validation_pipeline
        self.report_grad_norms = report_grad_norms
        del split_step          # the eager step is the split step
        self.device = next(dit.parameters()).device
        for frozen in (vae, encoder_adaptor):
            frozen.requires_grad_(False).eval()
        if trainable_filter is not None:
            for name, p in dit.named_parameters():
                p.requires_grad_(bool(trainable_filter(name)))
        leaves = [p for p in dit.parameters() if p.requires_grad]
        if optimizer is None:
            optimizer = torch.optim.AdamW(
                leaves, lr=tcfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=1e-4)
        self.update = straag_update(leaves, optimizer, tcfg, lr_scheduler)
        self.ema = ({n: p.detach().clone() for n, p in dit.named_parameters()}
                    if tcfg.use_ema else None)
        self.rng = np.random.RandomState(run_cfg.seed)
        self.generator = torch.Generator(self.device).manual_seed(
            run_cfg.seed)
        self.global_step = 0

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        return encode_streamed(self.vae, x)[0].float()

    # ---- batch assembly (host + frozen towers) --------------------------
    @torch.no_grad()
    def prepare_batch(self, samples: Sequence[SceneFlowSample],
                      prompts: Sequence[str]) -> dict:
        """Stack samples (one shape) -> the train step's batch dict."""
        cfg = self.dit.cfg
        rc = self.run_cfg

        def stack(arrays):
            return torch.from_numpy(np.stack(arrays)).to(self.device)

        flow = stack([s.flow for s in samples])
        control = stack([s.control_video for s in samples])
        t_frames = flow.shape[1]
        depth = stack([np.repeat(s.depth_image, t_frames, axis=0)
                       for s in samples])
        rgb01 = stack([s.first_frame_rgb for s in samples])

        # flow pixels -> pseudo-RGB -> frozen-VAE latents
        latents = self._encode(self.enc(flow) * 2.0 - 1.0)
        control_lat = self._encode(control)
        depth_lat = self._encode(depth)

        # the ref image's first latent frame as ref_conv tokens, zeroed with
        # 2% dropout; only for a DiT with the ref_conv path. The control
        # video is the repeated first frame, so its frame-0 latents are the
        # ref latents (taken before the control dropout below).
        full_ref = None
        if cfg.ref_conv:
            keep_r = [self.rng.choice([1.0, 0.0], p=[0.98, 0.02])
                      for _ in samples]
            full_ref = control_lat[:, 0] * self._keep(keep_r, 4)

        keep = [self.rng.choice([0.0, 1.0], p=[rc.control_dropout,
                                               1 - rc.control_dropout])
                for _ in samples]
        control_lat = control_lat * self._keep(keep, 5)

        ref_slot = torch.zeros_like(latents)  # the ref assignment is off
        y = torch.cat([control_lat, ref_slot, depth_lat], dim=-1)

        prompts = [("" if self.rng.rand() < rc.text_dropout else p)
                   for p in prompts]
        context = self.encode_text(prompts).float().to(self.device)

        batch = {"latents": latents, "y": y, "context": context}
        if full_ref is not None:
            batch["full_ref"] = full_ref

        if self.encode_clip is not None:
            clip_fea = self.encode_clip(rgb01 * 2.0 - 1.0).to(self.device)
            keep_c = [self.rng.choice([0.0, 1.0], p=[rc.clip_dropout,
                                                     1 - rc.clip_dropout])
                      for _ in samples]
            batch["clip_fea"] = clip_fea * self._keep(keep_c, 3)
        if self.extract_mpm is not None and cfg.motion_guidance:
            batch["mpm_features"] = self.extract_mpm(rgb01).to(self.device)
        return batch

    def _keep(self, keep, ndim):
        """Per-sample 0/1 factors shaped to broadcast over ndim dims."""
        return torch.tensor(keep, dtype=torch.float32,
                            device=self.device).reshape(-1, *[1] * (ndim - 1))

    # ---- train loop ------------------------------------------------------
    def _state(self):
        return dict(params=self.dit.state_dict(),
                    opt_state=self.update.state_dict(), ema=self.ema,
                    rng={"numpy": _numpy_state(self.rng),
                         "torch": self.generator.get_state()})

    def _restore(self, out):
        self.dit.load_state_dict(out["params"])
        self.update.load_state_dict(out["opt_state"])
        if self.ema is not None:
            for name, e in out["ema"].items():
                self.ema[name].copy_(e)
        name, key, pos, has_gauss, gauss = out["rng"]["numpy"]
        self.rng.set_state((name, key.cpu().numpy().astype(np.uint32), pos,
                            has_gauss, gauss))
        self.generator.set_state(out["rng"]["torch"].cpu())

    def train(self, sample_iterator: Iterator,
              extra_state: Optional[Callable[[], dict]] = None,
              restore_state: Optional[Callable[[dict], None]] = None,
              timings: Optional[list] = None):
        """sample_iterator yields (samples, prompts) batches.

        extra_state()/restore_state(d) carry the sampler position through
        the checkpoint for data-order resume. ``timings``, when given, gets
        one dict per step with the seconds of prepare_batch and of the
        step (the device synchronised after each). Returns (dit, ema)."""
        rc = self.run_cfg
        os.makedirs(rc.output_dir, exist_ok=True)
        metrics = MetricsLogger(rc.output_dir)
        mgr = CheckpointManager(rc.output_dir,
                                max_to_keep=rc.checkpoints_total_limit)

        if rc.resume and mgr.latest_step() is not None:
            # on the host: the copies go into the live tensors, so the card
            # never holds two copies of the state
            out = mgr.restore(with_extra=True, map_location="cpu")
            self._restore(out)
            extra = out.get("extra") or {}
            self.global_step = extra.get("global_step", 0)
            if restore_state and "data" in extra:
                restore_state(extra["data"])

        def sync():
            if timings is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        def log_step(step):
            return step % rc.log_steps == 0 or step == 1

        for samples, prompts in sample_iterator:
            if self.global_step >= rc.max_steps:
                break
            t0 = sync()
            batch = self.prepare_batch(samples, prompts)
            t1 = sync()
            idx, noise = draw(self.tcfg, batch, self.generator)
            step_metrics = train_step(
                self.dit, self.update, self.ema, self.tcfg, batch, idx,
                noise, self.global_step,
                report_grad_norms=(self.report_grad_norms
                                   and log_step(self.global_step + 1)))
            t2 = sync()
            if timings is not None:
                timings.append({"prepare_s": t1 - t0, "step_s": t2 - t1})
            self.global_step += 1

            if log_step(self.global_step):
                grad_norms = step_metrics.pop("grad_norms", None)
                metrics.log(self.global_step, step_metrics, prefix="train")
                if grad_norms is not None:
                    metrics.log(self.global_step, grad_norms,
                                prefix="grad_norm")
                print(f"step {self.global_step}: " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in step_metrics.items()))
            if rc.validation_steps and \
                    self.global_step % rc.validation_steps == 0:
                t3 = sync()
                self._validate(samples[0], prompts[0], metrics)
                if timings is not None:
                    timings[-1]["validation_s"] = sync() - t3
            if self.global_step % rc.checkpointing_steps == 0:
                extra = {"global_step": self.global_step}
                if extra_state:
                    extra["data"] = extra_state()
                mgr.save(self.global_step, extra=extra, **self._state())
        metrics.close()
        mgr.close()
        return self.dit, self.ema

    @torch.no_grad()
    def _validate(self, sample: SceneFlowSample, prompt: str,
                  metrics: MetricsLogger):
        """Sample through the validation pipeline from ``sample`` and
        ``prompt`` (with "" as the negative prompt) and write the video,
        mapped from [-1, 1] to [0, 1], as ``validation_<step>.gif``.
        Returns that video [1, T, H, W, 3], or None without a pipeline."""
        if self.validation_pipeline is None:
            return None
        from ..utils.artifacts import save_videos_grid

        dev = self.device
        pipe = self.validation_pipeline
        ctx = self.encode_text([prompt])
        neg = self.encode_text([""])
        rgb01 = torch.from_numpy(sample.first_frame_rgb)[None].to(dev)
        clip_fea = mpm = None
        if self.encode_clip is not None:
            clip_fea = self.encode_clip(rgb01 * 2.0 - 1.0)
        if self.extract_mpm is not None and self.dit.cfg.motion_guidance:
            mpm = self.extract_mpm(rgb01)
        video = pipe(torch.Generator(dev).manual_seed(self.run_cfg.seed),
                     ctx, neg_embeds=neg,
                     control_video=torch.from_numpy(
                         sample.control_video)[None].to(dev),
                     depth_image=torch.from_numpy(
                         sample.depth_image)[None].to(dev),
                     clip_fea=clip_fea, mpm_features=mpm,
                     output_type="no_normalize")
        vis = ((video.float() + 1.0) * 0.5).clamp(0.0, 1.0).cpu().numpy()
        save_videos_grid(os.path.join(self.run_cfg.output_dir,
                                      f"validation_{self.global_step}.gif"),
                         vis)
        metrics.log(self.global_step, {"validation_written": 1.0})
        return vis
