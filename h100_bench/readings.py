"""The controls' readings at a cell's own size, on the card:

    python3 h100_bench/readings.py --workload <name> --seeds 11,12,13 \
        [--controls fp8_products,fp8_kept]

For each seed and each control (``reference/dit.py CONTROLS``): the
plain reference put in the program's place and computed in fp8 (the
precision below the configuration's bf16 compute), judged by the cell's
own comparison against the fp32 reference, which runs once a seed. Each
line gives the numbers compared and their limits; a number's upper
reading is the least that the controls give, and some number has to
fail. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", default="fp8_products,fp8_kept")
    args = p.parse_args(argv)
    import torch

    from h100_bench import harness
    from h100_bench.reference.dit import CONTROLS

    w, cfg, traffic, _, _ = harness.cell(args.workload)
    card = harness.Card(w["chips"])
    driver = harness.load_file(harness.HERE / "drivers" /
                               f"{traffic['driver']}.py", "driver")
    precisions = {n: CONTROLS[n] for n in args.controls.split(",")}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        sess = driver.setup(cfg, traffic, seed, card.device, program=False)
        for name, checks in sess.controls(precisions).items():
            print(json.dumps({
                "workload": args.workload, "seed": seed, "control": name,
                "readings": {n: v for n, v, _ in checks},
                "limits": {n: lim for n, _, lim in checks},
                "fails": [n for n, v, lim in checks if not v <= lim],
                "seconds": time.perf_counter() - t0}), flush=True)
        del sess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
