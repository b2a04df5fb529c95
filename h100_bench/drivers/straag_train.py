"""Closed-loop 4D-STraG fine-tuning at batch 1: each step is the port's
``train/train_straag.py train_step`` on the DiT in fp32 weights with bf16
compute, every block rematerialised ('nothing'), the dynamic clamp, AdamW
and the EMA, as the CLI runs it. Batches cycle through a pool made in
set-up from the seed (latents, y, text, CLIP and MPM features); each
step's timestep index and noise come from (seed, step).

``correct`` follows two stretches of ``checked_steps`` steps, each
through the window's own call and feed. The start: set-up drives the
trainer from the seeded weights through its first steps, and the plain
fp32 reference follows them from the same seed. The window's last steps:
before them the harness stops the clock while the trainer's state
(weights, moments, EMA) is copied to the host, and the reference follows
them from that state. Each stretch gives each step's loss, each leaf's
first gradient as the optimizer got it (the change of its first moment
over 1 - beta1) and, after the last step, each leaf's change and its
EMA's change; each number compared is the worse of the two stretches.
"""

from __future__ import annotations

import torch

from h100_bench import compare, inputs
from h100_bench.drivers.denoise import build_dit
from h100_bench.reference import dit as ref_dit
from h100_bench.reference import train as ref_train

POOL_TAG = 200


class Session:
    unit = "step"

    def __init__(self, cfg, traffic, seed, device, program=True):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        pool = [inputs.conditioning(cfg, seed, POOL_TAG + j, device)
                for j in range(traffic["pool"])]
        self.pool = [{"latents": c["x"], "y": c["y"], "context": c["context"],
                      "clip_fea": c["clip_fea"],
                      "mpm_features": c["mpm_features"]} for c in pool]
        self.step = 0
        self.attempted = 0
        self.failed = 0
        # the window's last steps that the check follows (``measure``)
        self.tail = traffic["checked_steps"]
        self.readings = {}          # "start" and "window": what is compared
        self.held = None            # the state before the window's tail
        self.tail_losses = None
        self.dit = None
        if program:
            self._build()

    def _draw(self, step):
        return inputs.train_draw(self.seed, step,
                                 self.tr["num_train_timesteps"],
                                 self.pool[0]["latents"], self.device)

    def _build(self):
        from more4d_tpu_torch.train.optim import make_adamw
        from more4d_tpu_torch.train.train_straag import (StraagTrainConfig,
                                                         straag_update)

        tr = self.tr
        self.dit = build_dit(self.cfg, self.seed, self.device, torch.float32,
                             remat=True, remat_policy=tr["remat_policy"])
        self.dit.train()
        named = [(n, p) for n, p in self.dit.named_parameters()]
        self.opt, _ = make_adamw(named, tr["learning_rate"],
                                 betas=tuple(tr["adam_betas"]),
                                 weight_decay=tr["weight_decay"],
                                 eps=tr["adam_epsilon"])
        self.tcfg = StraagTrainConfig(
            learning_rate=tr["learning_rate"],
            max_grad_norm=tr["max_grad_norm"],
            abnormal_loss_threshold=tr["abnormal_loss_threshold"],
            abnormal_loss_start_step=tr["abnormal_loss_start_step"],
            grad_clip_decay_steps=tr["grad_clip_decay_steps"],
            mse_threshold=tr["mse_threshold"], shift=tr["shift"],
            num_train_timesteps=tr["num_train_timesteps"],
            ema_decay=tr["ema_decay"])
        self.update = straag_update([p for _, p in named], self.opt,
                                    self.tcfg)
        self.ema = {n: p.detach().clone() for n, p in named}
        self.named = named
        losses = []
        for k in range(tr["checked_steps"]):
            m = self._step()
            losses.append(m["loss"])
            if k == 0:
                b1 = tr["adam_betas"][0]
                # a leaf the optimizer did not step has no moment: 0
                grad = {n: (self._moment(p, "exp_avg").norm() / (1 - b1))
                        .item() for n, p in named}
        change, ema = self._changes(named)
        self.readings["start"] = {"loss": losses, "grad": grad,
                                  "change": change, "ema_change": ema}
        self._sync()

    def _moment(self, p, key):
        state = self.opt.state[p]
        return state[key] if key in state else torch.zeros_like(p)

    @torch.no_grad()
    def hold(self, i: int):
        """Called by ``measure`` with the clock stopped, before each of the
        window's last ``tail`` steps (``i`` < tail) and after the last:
        keep the state on the host before the first, the first gradient
        after it, and the changes after the last."""
        b1 = self.tr["adam_betas"][0]
        if i == 0:
            opt_steps = {int(self.opt.state[p]["step"])
                         for _, p in self.named if "step" in self.opt.state[p]}
            self.held = {
                "step": self.step, "adam_step": max(opt_steps, default=0),
                "state": {n: tuple(t.detach().to("cpu", copy=True) for t in (
                    p, self._moment(p, "exp_avg"),
                    self._moment(p, "exp_avg_sq"), self.ema[n]))
                    for n, p in self.named}}
            self.tail_losses = []
        elif i == 1:
            held = self.held["state"]
            self.readings["window"] = {"grad": {
                n: ((self._moment(p, "exp_avg") - b1 * held[n][1].to(
                    self.device)) / (1 - b1)).norm().item()
                for n, p in self.named}}
        if i == self.tail:
            held = self.held["state"]
            dev = self.device
            self.readings["window"].update(
                loss=self.tail_losses,
                change={n: (p - held[n][0].to(dev)).norm().item()
                        for n, p in self.named},
                ema_change={n: (self.ema[n] - held[n][3].to(dev)).norm()
                            .item() for n, _ in self.named})
            self.tail_losses = None

    @torch.no_grad()
    def _changes(self, named):
        """Each leaf's norm of (weights - seeded weights) and of (EMA -
        seeded weights), the seeded weights made again a group at a time."""
        weights, prefixes = inputs.group_maker(self.cfg, self.seed,
                                               torch.float32, self.device)
        params = dict(named)
        change, ema = {}, {}
        for prefix in prefixes:
            for k, p0 in weights(prefix).items():
                n = prefix + k
                change[n] = (params[n] - p0).norm().item()
                ema[n] = (self.ema[n] - p0).norm().item()
        return change, ema

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        from more4d_tpu_torch.train.train_straag import train_step

        batch = self.pool[self.step % len(self.pool)]
        idx, noise = self._draw(self.step)
        m = train_step(self.dit, self.update, self.ema, self.tcfg, batch, idx,
                       noise, self.step)
        self.step += 1
        return m

    def run_one(self) -> int:
        """One train step; returns 1 if its update was taken."""
        self.attempted += 1
        m = self._step()
        self._sync()
        if self.tail_losses is not None:
            self.tail_losses.append(m["loss"])
        if m["skipped"] or not m["updated"]:
            self.failed += 1
            return 0
        return 1

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"train_step_s": window_s / max(units, 1)}

    def release(self):
        self.dit = self.opt = self.update = self.ema = self.named = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _follow(self, first: int, pr, start=None):
        """The reference's readings over ``checked_steps`` steps from step
        ``first``, from the seeded weights or from ``start`` (the state
        held before the window's tail)."""
        ref_dit.exact_fp32()
        weights, prefixes = inputs.group_maker(self.cfg, self.seed,
                                               torch.float32, self.device)
        steps = range(first, first + self.tr["checked_steps"])
        batches = [{"x": b["latents"], **{k: b[k] for k in
                                          ("y", "context", "clip_fea",
                                           "mpm_features")}}
                   for b in (self.pool[k % len(self.pool)] for k in steps)]
        draws = [self._draw(k) for k in steps]
        out = ref_train.run_steps(weights, prefixes, self.cfg, self.tr,
                                  batches, draws, pr, start)
        names = out["names"]

        def by_name(t):
            return dict(zip(names, t.tolist()))
        return {"loss": out["loss"], "grad": by_name(out["grad"]),
                "grad_raw": by_name(out["grad_raw"]),
                "change": by_name(out["change"]),
                "ema_change": by_name(out["ema_change"])}

    def reference(self, pr=ref_dit.FP32):
        """The reference's readings over the stretches the program ran."""
        ref = {"start": self._follow(0, pr)}
        if self.held is not None:
            ref["window"] = self._follow(self.held["step"], pr, self.held)
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
                                    ("change_gap", "change", moving),
                                    ("ema_gap", "ema_change", moving)):
                leaf, gap = compare.worst_leaf(g.get(key, {}), r[key], keep)
                self.parts.setdefault(name, {})[part] = gap
                self.worst.setdefault(name, {})[part] = (
                    leaf, g.get(key, {}).get(leaf), r[key].get(leaf))
        return [(n, max(p.values()), lim[n]) for n, p in self.parts.items()]

    def notes(self):
        """Each number's stretches, and the leaf that sets each (its name,
        the program's norm, the reference's)."""
        return [f"stretch {n} {p} worst leaf {self.worst.get(n)}"
                for n, p in self.parts.items()]

    def verify(self):
        return self.judge(self.readings, self.reference())

    def controls(self, precisions):
        """{name: [(name, value, limit)]}: the reference over the start
        computed in each of ``precisions`` in the program's place, judged
        as the program's readings are."""
        ref = self.reference()
        return {name: self.judge(self.reference(pr), ref)
                for name, pr in precisions.items()}


def setup(cfg, traffic, seed, device, program=True):
    return Session(cfg, traffic, seed, device, program)
