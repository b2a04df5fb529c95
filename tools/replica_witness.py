#!/usr/bin/env python3
"""Is ``run_two_stage`` bit-reproducible between processes on one card?

    python tools/replica_witness.py [--out FILE]

Runs the one-process ``run_two_stage`` (no mesh) of ``chip_smoke.py``'s
mesh phase (the 1.3B two-stage models from seed 0 on the stand-in
conditioning, 2 steps a stage, 2 trajectories) in fresh processes:

- ``alone_a``, ``alone_b``: one process at a time, the card to itself;
- ``pair_0``, ``pair_1``: two processes at once, as the mesh phase's two
  ranks share the card;
- ``capped_0``, ``capped_1``: two at once, each held to 0.48 of the
  card's memory (``torch.cuda.set_per_process_memory_fraction``).

Each process records its stage intermediates (the control pipeline's
conditioning latents, every DiT output, the decoded flow video, the
adaptor's output, the clouds and the videos), the caching allocator's
``num_ooms`` and ``num_alloc_retries`` (an out-of-memory error that
PyTorch caught, as its cuDNN convolutions do when a plan's workspace does
not fit before they try the next plan), its peak, and the names of
the device kernels it ran (``torch.profiler``). Prints, for every
process, the largest difference of each intermediate from ``alone_a`` and
the device kernels it ran that ``alone_a`` did not (and the reverse), one
JSON object a line; the last line summarises. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 0.48


def one_run(label, out_path, cap):
    """A fresh process: ``run_two_stage`` with its intermediates kept."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from more4d_tpu_torch.infer import run_two_stage

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    if cap:
        torch.cuda.set_per_process_memory_fraction(cap)
    m, _, kw = chip_smoke.mesh_inference(dev)
    pipe = m.control_pipeline
    caps = {"dit": []}
    real_prep, real_decode = pipe.prepare_conditions, pipe.decode_latents
    real_fin = pipe.dit.finalize

    def prep(*a, **k):
        caps["y"] = real_prep(*a, **k)
        return caps["y"]

    def decode(*a, **k):
        caps["flow_video"] = real_decode(*a, **k)
        return caps["flow_video"]

    def fin(*a, **k):
        out = real_fin(*a, **k)
        caps["dit"].append(out)
        return out

    pipe.prepare_conditions, pipe.decode_latents = prep, decode
    pipe.dit.finalize = fin
    m.decoder_adaptor.register_forward_hook(
        lambda mod, inp, out: caps.__setitem__("adaptor", out))
    torch.cuda.reset_peak_memory_stats()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = run_two_stage(m, kw["image01"], kw["prompt"],
                            depth=kw["depth"],
                            trajectory_types=kw["trajectory_types"])
        torch.cuda.synchronize()
    kernels = sorted({e.key for e in prof.key_averages()})
    stats = torch.cuda.memory_stats()
    out = {k: (torch.stack([t.float() for t in v]) if k == "dit"
               else v.float()).cpu() for k, v in caps.items()}
    out["coords"] = run["coords"].float().cpu()
    out["videos"] = torch.stack([v["video"].float() for v in
                                 run["videos"]]).cpu()
    torch.save(dict(tensors=out, kernels=kernels, label=label,
                    num_ooms=stats.get("num_ooms", 0),
                    num_alloc_retries=stats.get("num_alloc_retries", 0),
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30),
               out_path)


def spawn(labels, root, cap):
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=one_run,
                         args=(lab, os.path.join(root, lab + ".pt"), cap))
             for lab in labels]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"{labels}: exit codes {codes}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the lines to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("replica_witness: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from more4d_tpu_torch.kernels import _build

    _build.build_all()
    lines = []
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        spawn(["alone_a"], root, None)
        spawn(["alone_b"], root, None)
        spawn(["pair_0", "pair_1"], root, None)
        spawn(["capped_0", "capped_1"], root, CAP)
        wall = time.perf_counter() - t0
        runs = {lab: torch.load(os.path.join(root, lab + ".pt"))
                for lab in ("alone_a", "alone_b", "pair_0", "pair_1",
                            "capped_0", "capped_1")}
    ref = runs["alone_a"]
    for lab, r in runs.items():
        diff = {}
        for k, want in ref["tensors"].items():
            got = r["tensors"][k]
            d = (got - want).abs()
            diff[k] = [d.max().item(),
                       (d.norm() / want.norm().clamp_min(1e-30)).item()]
        lines.append(dict(
            run=lab, num_ooms=r["num_ooms"],
            num_alloc_retries=r["num_alloc_retries"],
            peak_gib=r["peak_gib"],
            kernels_not_in_alone_a=sorted(set(r["kernels"]) -
                                          set(ref["kernels"])),
            kernels_only_in_alone_a=sorted(set(ref["kernels"]) -
                                           set(r["kernels"])),
            max_abs_and_rel_diff_from_alone_a=diff))
    lines.append(dict(summary=True, wall_s=wall, cap=CAP,
                      cudnn=torch.backends.cudnn.version(),
                      torch=torch.__version__, identical={
                          lab: all(v[0] == 0.0 for v in
                                   ln["max_abs_and_rel_diff_from_alone_a"]
                                   .values())
                          for lab, ln in zip(runs, lines)}))
    text = "\n".join(json.dumps(ln) for ln in lines)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
