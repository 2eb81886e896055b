"""The numbers that decide ``correct``: a job's first steps on the program
against the reference (reference.py), each number beside its limit.

* ``loss_gap``: the largest relative gap over the losses the steps report
  (each step's training loss, the validation loss after it, the final test
  loss);
* ``grad1_gap``: the first gradient of the output layer (the last weight),
  the gap between the program's norm and the reference's over the
  reference's norm;
* ``change_gap``: the weights' change over the steps, leaf by leaf, the
  worst leaf's gap between the two norms over the reference's norm of that
  leaf or of the median leaf, whichever is larger, over the leaves whose
  reference gradient is at least ``COUNTED_GRAD_SHARE`` of the median
  leaf's (a leaf with no gradient moves under Adam by rounding alone);
* ``grad1_diff``: the first gradient of the output layer, the norm of the
  difference over the reference's norm;
* ``grad1_l0_gap``, ``grad1_l0_diff``: the same two of the first layer's
  first gradient (the layer-0 product's dW). Adam's first steps move a
  weight by about lr·sign(g), so ``change_gap`` hardly sees a gradient off
  by a factor: these do;
* ``mask_z``: the program's dropout masks against independent draws at the
  configuration's rate, in binomial standard deviations, the largest over
  each step's kept share of X's nonzeros and of the hidden layer's positive
  entries, and over the share of those on which two consecutive steps'
  masks agree. A dropout left out reads the square root of the count
  (thousands at reddit's size), a mask drawn once and replayed reads as far.

The reference applies the program's masks (reference.py), so the other
numbers see a wrong scale of the kept values. The first layer's gradient
passes the ReLU's derivative, and where a pre-activation lies within float32
rounding of 0 rounding flips its term: its numbers read up to 40x a seed's
usual gap on a few seeds (PERF.md gives the readings). ``grad1_diff`` is
there because the norms average a product's rounding over many terms: they
read the TF32 control within 3x of float32's own rounding on reddit, and the
difference does not average it away.
"""

from __future__ import annotations

import math
import statistics

import torch

from benchmark.reference import Readings

COUNTED_GRAD_SHARE = 1e-3
NUMBERS = ("loss_gap", "grad1_gap", "change_gap", "grad1_diff", "grad1_l0_gap",
           "grad1_l0_diff", "mask_z")


def _worst(values: list[float]) -> float:
    """The largest of ``values``; infinite where one is not finite or none is given."""
    return max(values) if values and all(math.isfinite(v) for v in values) else math.inf


def _worst_leaf(prog: list[float], ref: list[float], counted: list[bool]) -> float:
    med = statistics.median(ref)
    return _worst([abs(p - r) / max(r, med) for p, r, c in zip(prog, ref, counted) if c])


def _norms(leaves: list[torch.Tensor]) -> list[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def _grad_numbers(prog: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(gap of the norms, norm of the difference), each over the reference's norm."""
    p, r, diff = _norms([prog, ref, prog - ref])
    return _worst([abs(p - r) / r]), _worst([diff / r])


def _z(count: int, n: int, share: float) -> float:
    """How far ``count`` of ``n`` lies from ``share`` of them, in binomial
    standard deviations."""
    return abs(count - share * n) / math.sqrt(share * (1.0 - share) * n) if n else 0.0


def mask_z(prog: Readings, ref: Readings) -> float:
    """``prog``'s masks against independent draws that keep ``ref.keep``,
    counted where a mask shows: X's nonzeros, and the hidden entries that are
    positive in the reference (a dropped value and a zero read alike)."""
    q = ref.keep
    if q >= 1.0:
        return 0.0
    if prog.masks is None or len(prog.masks) != len(ref.active):
        return math.inf
    agree = q * q + (1.0 - q) ** 2
    nz = ref.x_nonzero
    zs, prev = [], None
    for (m0, m1), act in zip(prog.masks, ref.active):
        if m0.shape != nz.shape or m1.shape != act.shape:
            return math.inf
        m0, m1 = m0 & nz, m1 & act
        zs += [_z(int(m0.sum()), int(nz.sum()), q), _z(int(m1.sum()), int(act.sum()), q)]
        if prev is not None:
            p0, p1, p_act = prev
            both = p_act & act
            zs += [_z(int(((p0 == m0) & nz).sum()), int(nz.sum()), agree),
                   _z(int(((p1 == m1) & both).sum()), int(both.sum()), agree)]
        prev = (m0, m1, act)
    return _worst(zs)


def numbers(prog: Readings, ref: Readings) -> dict[str, float]:
    """The compared numbers of ``prog`` judged against ``ref``; a non-finite
    reading reads as infinite."""
    p_losses = [*prog.train_loss, *prog.val_loss, prog.test_loss]
    r_losses = [*ref.train_loss, *ref.val_loss, ref.test_loss]
    ref_grad = _norms(ref.grad1)
    med = statistics.median(ref_grad)
    counted = [g >= COUNTED_GRAD_SHARE * med for g in ref_grad]
    out_gap, out_diff = _grad_numbers(prog.grad1[-1], ref.grad1[-1])
    l0_gap, l0_diff = _grad_numbers(prog.grad1[0], ref.grad1[0])
    return {"loss_gap": _worst([abs(p - r) / abs(r) for p, r in zip(p_losses, r_losses)]),
            "grad1_gap": out_gap,
            "change_gap": _worst_leaf(_norms(prog.change), _norms(ref.change), counted),
            "grad1_diff": out_diff, "grad1_l0_gap": l0_gap, "grad1_l0_diff": l0_diff,
            "mask_z": mask_z(prog, ref)}


def judge(values: dict[str, float], limits: dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in NUMBERS)
