"""The benchmark's CPU tests: ``python -m pytest h100_bench/tests -q``
from the root of the repository. Tests marked ``cuda`` need the card and
skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
