"""Probes of element gathers along either axis of a table, in every index form.

    python -m cuda_gcn_torch.probes.dyngather [--which forms|bisect|envelope|all]

The counterpart of three scripts that asked which forms of an in-kernel
dynamic gather the TPU compiler lowers, and at what rate:

* ``forms`` (scripts/exp_dyngather.py): ``sublane_kernel`` (:38), out[i, :] =
  Σ_k tab[idx[i, k], :] over a compact idx [S, steps], and ``lane_kernel``
  (:54), out[:, j] = Σ_k tab[:, idx[k, j]] over a compact idx [steps, L], at
  the script's four and three shapes, f32 and bf16 tables, f32 sums;
* ``bisect`` (scripts/exp_dyngather2.py:53-101): k1 one gather along axis 0
  with a full idx [S, L]; k2 the same with idx [S, 1] broadcast over the
  lanes; k3 a 64-step loop over a compact idx [S, 64]; k4 one gather along
  axis 1 with a full idx [16, 8192]; k5 ``take(tab, idx[S], axis 0)``;
* ``envelope`` (scripts/exp_dyngather3.py:22-63): 32 gathers of the same full
  idx, summed, along axis 0 at [8|32|256|1024, 128] and [8, 512] and along
  axis 1 at [8, 128] and [32, 2048].

On the card every form is one of two kernels (csrc/taa_probe.cu): ``taa_rows``
for axis 0 and ``taa_lanes`` for axis 1 (probes/taa.py), which read the index
array through three strides. A form is named by how its idx is laid out; a
case that does not run raises. Inputs come from numpy's ``default_rng(0)`` in
the scripts' order. The kernels add the same values in the same order as their
plain versions, so the two are equal bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys

import numpy as np
import torch

from cuda_gcn_torch.device import cuda_ms
from cuda_gcn_torch.probes import taa

# a form names how idx is laid out: full [S, L], one index per row ([S, 1] or
# [S]), or compact ([S, steps] for axis 0, [steps, L] for axis 1)
FORMS = ("full_rows", "bcast_rows", "take_rows", "compact_rows", "full_lanes",
         "compact_lanes")


def _layout(form: str, idx, s: int, l: int):
    """(axis, strides (i, j, k) in elements of idx, steps) of ``form`` on a
    table [s, l]; raises for an idx of another shape."""
    if form in ("full_rows", "full_lanes"):
        want, strides, steps = (s, l), (l, 1, 0), 1
    elif form == "bcast_rows":
        want, strides, steps = (s, 1), (1, 0, 0), 1
    elif form == "take_rows":
        want, strides, steps = (s,), (1, 0, 0), 1
    elif form == "compact_rows":
        steps = int(idx.shape[-1])
        want, strides = (s, steps), (steps, 0, 1)
    elif form == "compact_lanes":
        steps = int(idx.shape[0])
        want, strides = (steps, l), (0, 1, l)
    else:
        raise ValueError(f"unknown form {form!r}; one of {FORMS}")
    if tuple(idx.shape) != want:
        raise ValueError(f"form {form} takes idx {want} with a table [{s}, {l}], "
                         f"got {tuple(idx.shape)}")
    return int(form.endswith("lanes")), strides, steps


def gather(form: str, idx, tab, reps: int = 1) -> torch.Tensor:
    """The gather of ``form`` (one of ``FORMS``) summed over its steps and
    ``reps`` repeats, [S, L] f32: the kernel for a CUDA table, the plain version
    for a table on the CPU."""
    axis, strides, steps = _layout(form, idx, *tab.shape)
    return (taa.taa_lanes if axis else taa.taa_rows)(idx, strides, tab, steps, reps)


def gather_plain(form: str, idx, tab, reps: int = 1) -> torch.Tensor:
    """Plain version of ``gather``: ``take_along_dim`` step by step."""
    axis, strides, steps = _layout(form, idx, *tab.shape)
    return (taa.taa_lanes_plain if axis else taa.taa_rows_plain)(idx, strides, tab, steps,
                                                                 reps)


def sublane_gather(idx, tab) -> torch.Tensor:
    """``sublane_kernel``: out[i, :] = Σ_k tab[idx[i, k], :], idx [S, steps]."""
    return gather("compact_rows", idx, tab)


def lane_gather(idx, tab) -> torch.Tensor:
    """``lane_kernel``: out[:, j] = Σ_k tab[:, idx[k, j]], idx [steps, L]."""
    return gather("compact_lanes", idx, tab)


@dataclasses.dataclass
class Case:
    """One line of a script: a form at a shape, with its inputs. The layout of
    the form (axis, strides, steps) is worked out once, when the case is made."""

    group: str      # 'forms' | 'bisect' | 'envelope'
    label: str
    form: str
    idx: torch.Tensor
    tab: torch.Tensor
    reps: int = 1
    axis: int = dataclasses.field(init=False)
    strides: tuple = dataclasses.field(init=False)
    steps: int = dataclasses.field(init=False)

    def __post_init__(self):
        self.axis, self.strides, self.steps = _layout(self.form, self.idx, *self.tab.shape)

    def run(self) -> torch.Tensor:
        fn = taa.taa_lanes if self.axis else taa.taa_rows
        return fn(self.idx, self.strides, self.tab, self.steps, self.reps)

    def plain(self) -> torch.Tensor:
        fn = taa.taa_lanes_plain if self.axis else taa.taa_rows_plain
        return fn(self.idx, self.strides, self.tab, self.steps, self.reps)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (S, L, table type, steps) of exp_dyngather.py:84-87 and :110-112
SUBLANE_SHAPES = ((8192, 128, "float32", 64), (8192, 128, "bfloat16", 64),
                  (32768, 128, "bfloat16", 64), (1024, 128, "float32", 64))
LANE_SHAPES = ((16, 8192, "bfloat16", 64), (16, 32768, "bfloat16", 16),
               (128, 8192, "float32", 64))
# (S, L, axis) of exp_dyngather3.py:59-63, 32 repeats each
ENVELOPE_SHAPES = ((8, 128, 0), (32, 128, 0), (256, 128, 0), (1024, 128, 0), (8, 512, 0),
                   (8, 128, 1), (32, 2048, 1))
ENVELOPE_REPS = 32
BISECT_STEPS = 64


def _table(rng, s, l, dtype, device):
    return torch.from_numpy(rng.standard_normal((s, l)).astype(np.float32)).to(
        device=device, dtype=_DTYPES[dtype])


def _indices(rng, hi, shape, device):
    return torch.from_numpy(rng.integers(0, hi, size=shape, dtype=np.int32)).to(device)


def forms_cases(device, scale: int = 1) -> list[Case]:
    """The cases of exp_dyngather.py; ``scale`` divides S (sublane) or L (lane)
    for a small run."""
    rng = np.random.default_rng(0)
    out = []
    for s, l, dt, steps in SUBLANE_SHAPES:
        s //= scale
        tab = _table(rng, s, l, dt, device)
        idx = _indices(rng, s, (s, steps), device)
        out.append(Case("forms", f"[0] sublane-gather tab[{s}x{l}] {dt} x{steps} cols",
                        "compact_rows", idx, tab))
    for s, l, dt, steps in LANE_SHAPES:
        l //= scale
        tab = _table(rng, s, l, dt, device)
        idx = _indices(rng, l, (steps, l), device)
        out.append(Case("forms", f"[1] lane-gather tab[{s}x{l}] {dt} x{steps} rows",
                        "compact_lanes", idx, tab))
    return out


def bisect_cases(device, s: int = 8192, l: int = 128, s2: int = 16,
                 l2: int = 8192) -> list[Case]:
    """The five cases of exp_dyngather2.py, inputs drawn in its order."""
    rng = np.random.default_rng(0)
    tab = _table(rng, s, l, "float32", device)
    idx_full = _indices(rng, s, (s, l), device)
    idx_col = _indices(rng, s, (s, 1), device)
    idx_steps = _indices(rng, s, (s, BISECT_STEPS), device)
    tab2 = _table(rng, s2, l2, "float32", device)
    idx2 = _indices(rng, l2, (s2, l2), device)
    idx1d = _indices(rng, s, (s,), device)
    return [Case("bisect", "single TAA axis0, full idx", "full_rows", idx_full, tab),
            Case("bisect", "single TAA axis0, bcast idx [S,1]", "bcast_rows", idx_col, tab),
            Case("bisect", f"fori x{BISECT_STEPS} TAA axis0", "compact_rows", idx_steps, tab),
            Case("bisect", f"single TAA axis1 [{s2}x{l2}]", "full_lanes", idx2, tab2),
            Case("bisect", "jnp.take axis0 idx[S]", "take_rows", idx1d, tab)]


def envelope_cases(device, shapes=ENVELOPE_SHAPES, reps: int = ENVELOPE_REPS) -> list[Case]:
    """The shape sweep of exp_dyngather3.py: ``reps`` gathers of one full idx."""
    rng = np.random.default_rng(0)
    out = []
    for s, l, axis in shapes:
        tab = _table(rng, s, l, "float32", device)
        idx = _indices(rng, s if axis == 0 else l, (s, l), device)
        out.append(Case("envelope", f"TAA axis{axis} [{s}x{l}] float32 x{reps}",
                        "full_rows" if axis == 0 else "full_lanes", idx, tab, reps))
    return out


GROUPS = {"forms": forms_cases, "bisect": bisect_cases, "envelope": envelope_cases}


def rate_line(case: Case, ms: float) -> str:
    """A case's time in its script's units."""
    s, l = case.tab.shape
    item = case.tab.element_size()
    if case.group == "forms" and case.axis == 0:
        rows = s * case.steps
        return (f"{case.label}: {ms:8.4f} ms -> {ms * 1e6 / rows:.3f} ns/row "
                f"({rows * l * item / ms / 1e6:.0f} GB/s)")
    if case.group == "forms":
        cols = l * case.steps
        return (f"{case.label}: {ms:8.4f} ms -> {ms * 1e6 / cols:.3f} ns/col "
                f"({cols * s * item / ms / 1e6:.0f} GB/s)")
    if case.group == "envelope":
        return (f"OK   {case.label}: {ms:.4f} ms -> "
                f"{ms * 1e6 / (s * l * case.reps):.4f} ns/elem")
    line = f"OK   {case.label}: {ms:.4f} ms/call"
    if case.form == "compact_rows":
        rows = s * case.steps
        line += f"\n     -> {ms * 1e6 / rows:.3f} ns/row, {rows * l * item / ms / 1e6:.0f} GB/s"
    return line


def run(which: str = "all", iters: int = 5) -> list[tuple[Case, float]]:
    """Time every case of ``which`` ('forms', 'bisect', 'envelope' or 'all') on
    the card; returns [(case, ms per launch)]."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device and none is available")
    groups = list(GROUPS) if which == "all" else [which]
    out = []
    for g in groups:
        for case in GROUPS[g]("cuda"):
            out.append((case, cuda_ms(case.run, iters)))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_gcn_torch.probes.dyngather")
    ap.add_argument("--which", default="all", choices=[*GROUPS, "all"])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    res = run(args.which, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device={torch.cuda.get_device_name(0)} ({smi})")
    for case, ms in res:
        print(rate_line(case, ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
