"""Nothing under h100_bench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``more4d_tpu_torch`` begins with ``more4d_tpu`` and is allowed."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "more4d_tpu"}


def _imports(path):
    """(top-level name, relative level) of every import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node.level))
    return out


def test_no_file_imports_jax_or_the_jax_package():
    bad = [f"{p.relative_to(BENCH)}: {m}" for p in BENCH.rglob("*.py")
           for m, level in _imports(p) if level == 0 and m in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "typing", "numpy", "torch",
               "h100_bench"}
    for p in (BENCH / "reference").rglob("*.py"):
        for m, level in _imports(p):
            if level:
                continue
            assert m in allowed, f"{p.name} imports {m}"
            assert m != "more4d_tpu_torch"


def test_importing_the_reference_and_yardstick_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import h100_bench.reference.dit, h100_bench.reference.train, "
            "h100_bench.reference.fp8, h100_bench.yardstick.trace, "
            "h100_bench.yardstick.counts, h100_bench.inputs, "
            "h100_bench.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'more4d_tpu', 'more4d_tpu_torch'}))"
            % str(BENCH.parent))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    """A driver's module graph (the program included) loads no JAX: every
    module a tiny run imports, compared by its whole top-level name."""
    code = ("import sys; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); "
            "import _tiny; _tiny.run_cell('more4d-1.3b.straag_denoise'); "
            "from h100_bench import harness; "
            "print(harness.forbidden_modules())"
            % (str(BENCH.parent), str(BENCH / "tests")))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
