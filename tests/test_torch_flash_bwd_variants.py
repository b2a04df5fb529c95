"""``tools/flash_bwd_variants.py`` edits copies of the kernels' CUDA
sources (K1, K2/K3 and K4) by exact text. Every edit of every variant must
still find its text in the sources as they are and change them, so that an
edit of those lines shows here and not only on a card."""

import importlib.util
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "flash_bwd_variants", ROOT / "tools" / "flash_bwd_variants.py")
variants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(variants)

EDITED = {name: edits for name, edits in
          {**variants.TIMINGS, **variants.FAULTS}.items() if edits}


def test_every_kernel_source_has_a_planted_fault():
    faulted = {rel for edits in variants.FAULTS.values()
               for rel, _, _ in edits}
    for src in sorted((ROOT / "more4d_tpu_torch" / "csrc").glob("*.cu")):
        assert str(src.relative_to(ROOT)) in faulted, src.name


@pytest.mark.parametrize("name", sorted(EDITED))
def test_variant_edits_apply_to_the_sources(tmp_path, name):
    csrc = "more4d_tpu_torch/csrc"
    shutil.copytree(ROOT / csrc, tmp_path / csrc)
    variants.apply_edits(tmp_path, EDITED[name])
    for rel in {rel for rel, _, _ in EDITED[name]}:
        assert (tmp_path / rel).read_text() != (ROOT / rel).read_text()
