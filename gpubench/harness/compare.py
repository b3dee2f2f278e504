"""The numbers that decide ``correct``, each the gap between what the
program produced and what the plain reference works out from the same
inputs."""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch


def rel_gap(a: float, b: float) -> float:
    """|a - b| relative to the reference's |b|; infinite where either is
    not finite."""
    g = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    return g if math.isfinite(g) else math.inf


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's
    (not the norm of their difference), relative to the reference's norm
    of that leaf or of the median leaf, whichever is larger, over the
    leaves in `keep` (all of them by default); infinite where a norm is
    not finite."""
    keys = sorted(ref if keep is None else keep)
    pn = leaf_norms({k: prog[k] for k in keys})
    rn = leaf_norms({k: ref[k] for k in keys})
    med = sorted(rn.values())[len(rn) // 2]
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def worst_leaf_gap(prog, ref, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def median_leaf_gap(prog, ref, keep=None) -> float:
    """The median leaf's gap: steady from seed to seed where the worst
    leaf's swings with the rounding of a few of its elements."""
    gaps = sorted(leaf_gaps(prog, ref, keep).values())
    return gaps[len(gaps) // 2]


def moving_leaves(first_grads: Dict[str, torch.Tensor],
                  share: float = 1e-3):
    """The leaves whose first reference gradient's norm is at least
    `share` of the median leaf's: a leaf below it (a gradient nought to
    rounding) moves under Adam by round-off alone, and is left out of
    the parameters' change."""
    n = leaf_norms(first_grads)
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= share * med]


def max_abs_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest elementwise gap; a NaN anywhere reads as infinity."""
    d = (a.double() - b.double()).abs()
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(d.max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when the program's numbers are exactly the limited ones,
    each finite and within its limit."""
    return set(numbers) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
