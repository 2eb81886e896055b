"""Judging a job's first steps on the program against a family's reference:
the statistics that a family's ``numbers`` builds its compared numbers from,
and ``judge``, each number against its limit in the cell file's ``limits``.

A non-finite reading reads as infinite, so that it fails any limit.
"""

from __future__ import annotations

import math
import statistics

import torch

COUNTED_GRAD_SHARE = 1e-3


def worst(values: list[float]) -> float:
    """The largest of ``values``; infinite where one is not finite or none is given."""
    return max(values) if values and all(math.isfinite(v) for v in values) else math.inf


def worst_leaf(prog: list[float], ref: list[float], counted: list[bool]) -> float:
    """The largest gap between the program's and the reference's norm of a
    counted leaf, over the reference's norm of that leaf or of the median
    leaf, whichever is larger (some leaves are all but zero)."""
    med = statistics.median(ref)
    return worst([abs(p - r) / max(r, med) for p, r, c in zip(prog, ref, counted) if c])


def norms(leaves: list[torch.Tensor]) -> list[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def grad_numbers(prog: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(gap of the norms, norm of the difference), each over the reference's norm."""
    p, r, diff = norms([prog, ref, prog - ref])
    return worst([abs(p - r) / r]), worst([diff / r])


def loss_gap(prog: list[float], ref: list[float]) -> float:
    """The largest relative gap over paired losses."""
    return worst([abs(p - r) / abs(r) for p, r in zip(prog, ref)])


def change_gap(prog: list[torch.Tensor], ref: list[torch.Tensor],
               ref_grad: list[torch.Tensor]) -> float:
    """The weights' change leaf by leaf (``worst_leaf``), over the leaves whose
    reference gradient ``ref_grad`` is at least ``COUNTED_GRAD_SHARE`` of the
    median leaf's: a leaf with no gradient moves under Adam by rounding alone."""
    grad = norms(ref_grad)
    med = statistics.median(grad)
    return worst_leaf(norms(prog), norms(ref), [g >= COUNTED_GRAD_SHARE * med for g in grad])


def z(count: int, n: int, share: float) -> float:
    """How far ``count`` of ``n`` lies from ``share`` of them, in binomial
    standard deviations."""
    return abs(count - share * n) / math.sqrt(share * (1.0 - share) * n) if n else 0.0


def judge(values: dict[str, float], limits: dict[str, float]) -> bool:
    """Whether every number lies within its limit; the two must name the same numbers."""
    if set(values) != set(limits):
        raise ValueError(f"the numbers {sorted(values)} and the limits {sorted(limits)} differ")
    return all(values[k] <= limits[k] for k in limits)
