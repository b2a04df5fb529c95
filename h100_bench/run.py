"""The port's benchmark: one run of one cell.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``check``: each number compared beside its limit).
Without a CUDA device, or without the program beside it, the run exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "h100_bench"

# every cache at a fixed place inside the checkout; no library that the
# program uses may load JAX
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# one host thread for PyTorch's CPU work: the process drives the card and
# shares the host's cores with its neighbours
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        from h100_bench import harness
    except ImportError as e:
        print(f"h100_bench: cannot load the harness: {e}", file=sys.stderr)
        return 2
    try:
        return harness.run(args, T_START)
    except harness.NoResult as e:
        print(f"h100_bench: no result: {e}", file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"h100_bench: the program is not there: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
