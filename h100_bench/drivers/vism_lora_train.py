"""Closed-loop 4D-ViSM LoRA fine-tuning of the InP DiT with its frozen
blocks streamed from pinned host memory (``--offload_blocks``), batch 1:
each step is the port's ``StreamedLoRATrainer.train_step``, as
``scripts/train_vism.py run_training`` builds and runs it:
``make_streamed_lora_trainer`` over the streamed DiT, then
``GradUpdate`` over ``factor_leaves`` with AdamW at the CLI's defaults
(``make_lr_schedule``, ``make_optimizer``). Batches cycle through a pool
made in set-up from the seed (latents, y, text and CLIP features); each
step's timestep index and noise come from (seed, step).

Set-up builds the streamed DiT as ``denoise_stream.build_streamed`` does
(each block made from the seed into pinned host memory by the program's
``offload_blocks_to_host``), the resident part in fp32 holding those
bf16 values, as the CLI loads a bf16 checkpoint; the LoRA's factors are
then set to ``reference/lora.py factors``, drawn from the seed with
``up`` non-zero.

``correct`` follows two stretches of ``checked_steps`` steps, as
``straag_train`` does: the start, from the seeded factors, and the
window's last steps, from the factors and AdamW's moments held on the
host with the clock stopped. Each gives each step's loss, each factor's
first gradient as AdamW got it (clipped: the change of its first moment
over 1 - beta1) and each factor's change over the stretch, against the
plain fp32 reference (``reference/lora.py``); each number compared is
the worse of the two stretches.
"""

from __future__ import annotations

import math

import torch

from h100_bench import compare, inputs
from h100_bench.drivers.denoise_stream import build_streamed
from h100_bench.reference import dit as ref_dit
from h100_bench.reference import lora as ref_lora

POOL_TAG = 300


def counters() -> dict:
    """The program's counters of the work a step launches; a counter the
    program lacks reads None."""
    from more4d_tpu_torch.kernels import rownorm, widen
    from more4d_tpu_torch.parallel.offload import StreamedDiT
    from more4d_tpu_torch.train.lora_streamed import StreamedLoRATrainer

    return {"K5": rownorm.rownorm_cuda.launches,
            "K5 backward": rownorm.rownorm_bwd_cuda.launches,
            "K6": widen.widen_fp8_cuda.launches,
            "copies": StreamedDiT.copies,
            "copied_bytes": StreamedDiT.copied_bytes,
            "side_paths": getattr(StreamedLoRATrainer, "side_paths", None)}


class Session:
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, program=True):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        pool = [inputs.conditioning(cfg, seed, POOL_TAG + j, device)
                for j in range(traffic["pool"])]
        self.pool = [{"latents": c["x"], "y": c["y"], "context": c["context"],
                      "clip_fea": c["clip_fea"]} for c in pool]
        self.names = ref_lora.leaf_names(cfg)
        self.step = 0
        self.attempted = 0
        self.failed = 0
        # the window's last steps that the check follows (``measure``)
        self.tail = traffic["checked_steps"]
        self.readings = {}          # "start" and "window": what is compared
        self.held = None            # the state before the window's tail
        self.tail_losses = None
        self.trainer = None
        self.counted = None
        if program:
            self.counted = counters()
            self._build()

    def _draw(self, step):
        return inputs.train_draw(self.seed, step,
                                 self.tr["num_train_timesteps"],
                                 self.pool[0]["latents"], self.device)

    def _build(self):
        from more4d_tpu_torch.parallel.offload import StreamedDiT
        from more4d_tpu_torch.train.lora_streamed import \
            make_streamed_lora_trainer
        from more4d_tpu_torch.train.optim import (GradUpdate,
                                                  make_lr_schedule,
                                                  make_optimizer)
        from more4d_tpu_torch.train.train_vism import (VismTrainConfig,
                                                       factor_leaves)

        cfg, tr, dev = self.cfg, self.tr, self.device
        resident, host = build_streamed(cfg, self.seed, dev)
        tcfg = VismTrainConfig(
            learning_rate=tr["learning_rate"],
            max_grad_norm=tr["max_grad_norm"],
            mse_threshold=tr["mse_threshold"], shift=tr["shift"],
            num_train_timesteps=tr["num_train_timesteps"],
            uniform_sampling=tr["uniform_sampling"],
            weighting_scheme=tr["weighting_scheme"])
        self.trainer, self.lora = make_streamed_lora_trainer(
            StreamedDiT(resident.float(), host, dev), tcfg,
            torch.Generator(dev).manual_seed(self.seed),
            rank=cfg["lora_rank"], alpha=cfg["lora_alpha"], quantize="fp8",
            device=dev, acts_on_host=tr["acts_on_host"])
        del resident, host
        seeded = ref_lora.factors(cfg, self.seed, dev)
        if set(seeded) != set(self.lora["factors"]):
            raise ValueError("the program's LoRA targets and the "
                             "reference's differ")
        with torch.no_grad():
            for name, f in self.lora["factors"].items():
                for k in ("down", "up"):
                    f[k].copy_(seeded[name][k])
        del seeded
        self.leaves = factor_leaves(self.lora)
        opt, sched = make_optimizer(
            "adamw", self.leaves,
            make_lr_schedule(tr["learning_rate"], tr["lr_scheduler"], 0, 1),
            betas=tuple(tr["adam_betas"]), weight_decay=tr["weight_decay"],
            eps=tr["adam_epsilon"])
        self.opt = opt
        self.update = GradUpdate(self.leaves, opt, sched, tcfg.max_grad_norm)
        start = [p.detach().clone() for p in self.leaves]
        losses = []
        for k in range(tr["checked_steps"]):
            losses.append(self._step()["loss"])
            if k == 0:
                grad = self._grads()
        self.readings["start"] = {
            "loss": losses, "grad": grad,
            "change": self._by_name((p - q).norm().item()
                                    for p, q in zip(self.leaves, start))}
        self._sync()

    def _by_name(self, values):
        return dict(zip(self.names, values))

    def _moment(self, p, key):
        state = self.opt.state[p]
        return state[key] if key in state else torch.zeros_like(p)

    def _grads(self, before=None):
        """Each factor's gradient as AdamW last got it, from its first
        moment now and ``before`` the step (zero where not given)."""
        b1 = self.tr["adam_betas"][0]
        out = []
        for j, p in enumerate(self.leaves):
            m = self._moment(p, "exp_avg")
            if before is not None:
                m = m - b1 * before[j].to(self.device)
            out.append((m / (1 - b1)).norm().item())
        return self._by_name(out)

    @torch.no_grad()
    def hold(self, i: int):
        """Called by ``measure`` with the clock stopped, before each of the
        window's last ``tail`` steps (``i`` < tail) and after the last:
        keep the state on the host before the first, the first gradient
        after it, and the changes after the last."""
        if i == 0:
            self.held = {
                "step": self.step, "adam_step": self.update.steps,
                "state": {n: tuple(t.detach().to("cpu", copy=True) for t in (
                    p, self._moment(p, "exp_avg"),
                    self._moment(p, "exp_avg_sq")))
                    for n, p in zip(self.names, self.leaves)}}
            self.tail_losses = []
        elif i == 1:
            self.readings["window"] = {"grad": self._grads(
                [self.held["state"][n][1] for n in self.names])}
        if i == self.tail:
            held = self.held["state"]
            self.readings["window"].update(
                loss=self.tail_losses,
                change=self._by_name(
                    (p - held[n][0].to(self.device)).norm().item()
                    for n, p in zip(self.names, self.leaves)))
            self.tail_losses = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        batch = self.pool[self.step % len(self.pool)]
        idx, noise = self._draw(self.step)
        m = self.trainer.train_step(self.lora, self.update, batch, idx, noise)
        self.step += 1
        return m

    def run_one(self) -> int:
        """One train step; returns 1 if its update was taken on a finite
        loss."""
        self.attempted += 1
        m = self._step()
        self._sync()
        if self.tail_losses is not None:
            self.tail_losses.append(m["loss"])
        if not m["updated"] or not math.isfinite(m["loss"]):
            self.failed += 1
            return 0
        return 1

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"train_step_s": window_s / max(units, 1)}

    def release(self):
        if self.counted is not None:
            now = counters()
            self.counted = {k: None if v is None or now[k] is None
                            else (now[k] - v) / max(self.step, 1)
                            for k, v in self.counted.items()}
        self.trainer = self.lora = self.leaves = self.opt = None
        self.update = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _follow(self, first: int, pr, weights, start=None):
        """The reference's readings over ``checked_steps`` steps from step
        ``first``, from the seeded factors or from ``start`` (the state
        held before the window's tail)."""
        steps = range(first, first + self.tr["checked_steps"])
        batches = [self.pool[k % len(self.pool)] for k in steps]
        draws = [self._draw(k) for k in steps]
        top, blocks = weights
        out = ref_lora.run_steps(
            top, blocks, ref_lora.factors(self.cfg, self.seed, self.device),
            self.cfg, self.tr, batches, draws, pr, start)

        def by_name(values):
            return dict(zip(out["names"], values))
        return {"loss": out["loss"], "grad": by_name(out["grad"]),
                "grad_raw": by_name(out["grad_raw"]),
                "change": by_name(out["change"])}

    def reference(self, pr=ref_dit.FP32):
        """The reference's readings over the stretches the program ran."""
        ref_dit.exact_fp32()
        if self.device.type == "cuda":
            # the blocks an earlier reference or the program cached, back
            # to the card: the reference fills most of it
            torch.cuda.empty_cache()
        weights = ref_lora.stored(self.cfg, self.seed, self.device)
        ref = {"start": self._follow(0, pr, weights)}
        if self.held is not None:
            ref["window"] = self._follow(self.held["step"], pr, weights,
                                         self.held)
        return ref

    def judge(self, got, ref):
        """[(name, value, limit)] of readings ``got`` against ``ref``, each
        number the worse over the stretches ``ref`` holds; ``self.parts``
        keeps each stretch's."""
        lim = self.tr["limits"]
        self.parts, self.worst = {}, {}
        for part, r in ref.items():
            g = got.get(part, {})
            moving = compare.moving_leaves(r["grad_raw"])
            self.parts.setdefault("loss_gap", {})[part] = compare.loss_gap(
                g.get("loss", []), r["loss"])
            for name, key, keep in (("grad_gap", "grad", None),
                                    ("change_gap", "change", moving)):
                leaf, gap = compare.worst_leaf(g.get(key, {}), r[key], keep)
                self.parts.setdefault(name, {})[part] = gap
                self.worst.setdefault(name, {})[part] = (
                    leaf, g.get(key, {}).get(leaf), r[key].get(leaf))
        return [(n, max(p.values()), lim[n]) for n, p in self.parts.items()]

    def notes(self):
        """Each number's stretches and the factor that sets each (its name,
        the program's norm, the reference's); the program's counters a
        step."""
        return [f"stretch {n} {p} worst leaf {self.worst.get(n)}"
                for n, p in self.parts.items()] + \
            [f"counters a step {self.counted}"]

    def verify(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        checks = self.judge(self.readings, self.reference())
        if self.device.type == "cuda":
            self.counted["reference peak bytes"] = \
                torch.cuda.max_memory_allocated(self.device)
        return checks

    def controls(self, precisions):
        """{name: [(name, value, limit)]}: the reference over the start
        computed in each of ``precisions`` in the program's place, judged
        as the program's readings are."""
        ref = self.reference()
        return {name: self.judge(self.reference(pr), ref)
                for name, pr in precisions.items()}


def setup(cfg, traffic, seed, device, program=True):
    return Session(cfg, traffic, seed, device, program)
