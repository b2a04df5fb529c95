"""The comparisons that decide ``correct``: each gives one number, which
a cell's traffic file holds to a limit (``limits``)."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch


def finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def latent_gap(out: torch.Tensor, ref: torch.Tensor,
               start: torch.Tensor) -> float:
    """||out - ref|| / ||ref - start||: the program's final latents against
    the reference's, relative to how far the reference moved them from
    the starting noise (a step that changes nothing reads 1)."""
    out, ref, start = out.double(), ref.double(), start.double()
    return finite(((out - ref).norm() / (ref - start).norm()).item())


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    """The largest |loss - reference loss| / |reference loss| over steps
    (inf where the program has another number of steps)."""
    prog, ref = list(prog), list(ref)
    if len(prog) != len(ref):
        return math.inf
    return finite(max(abs(p - r) / abs(r) for p, r in zip(prog, ref)))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's |norm - reference norm| / max(reference norm of the
    leaf, the median leaf's reference norm), over ``keep`` (all leaves
    by default)."""
    return worst_leaf(prog, ref, keep)[1]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Optional[Iterable[str]] = None):
    """(name, gap) of the leaf that sets :func:`leaf_gap`."""
    names = list(ref if keep is None else keep)
    vals = sorted(ref[n] for n in ref)
    median = vals[len(vals) // 2]
    worst = (None, 0.0)
    for n in names:
        if n not in prog:
            return n, math.inf
        gap = abs(prog[n] - ref[n]) / max(ref[n], median)
        if gap > worst[1]:
            worst = (n, gap)
    return worst[0], finite(worst[1])


def moving_leaves(grad_raw: Dict[str, float], rule: float = 1e-3):
    """The leaves whose reference gradient is more than ``rule`` x the
    median leaf's: the others move under Adam by rounding alone."""
    vals = sorted(grad_raw.values())
    median = vals[len(vals) // 2]
    return [n for n, g in grad_raw.items() if g > rule * median]
