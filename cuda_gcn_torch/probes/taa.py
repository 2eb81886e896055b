"""Probes of the take-along-axis formulation of the residual piece on the card.

    python -m cuda_gcn_torch.probes.taa [--s 16384] [--reps 16] [--iters 5]

The counterpart of scripts/exp_pallas_taa.py, with its inputs and defaults.
That script expresses both halves of a sorted piece aggregation with
same-shape ``take_along_axis`` only: a row gather with a broadcast index, and a
sorted segment sum as a column scan read at the segment boundaries. Its three
kernel bodies are, on an [S, 128] f32 table:

* A2 (``taa_kernel``, exp_pallas_taa.py:77): out[i] = Σ_{r<reps} tab[ids[i]];
* C (``cumsum_kernel``, :98): out = Σ_{r<reps} cumsum(tab, axis 0). The body
  adds ``acc * 0`` to the table before each scan; for finite inputs that
  changes nothing, and the port does not reproduce what it does to an
  infinity or a NaN;
* D (``piece_kernel``, :117): vals = tab[ids]·coef, cs = [0; cumsum(vals, 0)],
  out = Σ_{r<reps} (cs[end] − cs[begin]) with begin and end in [0, S].

The four kernels are in csrc/taa_probe.cu: ``taa_rows`` and ``taa_lanes`` (an
element gather along axis 0 or 1 whose index array is read through three
strides, so that one entry point serves full, compact and broadcast indices; A2
is ``taa_rows`` with one index per row, which its launcher gives to the form
that reads whole rows), ``cumsum_cols`` and ``piece``.
probes/dyngather.py drives the other forms. A2 repeats its gather ``reps``
times. C and D are one cooperative launch each: every CTA scans a tile of 128
rows by 128 columns in registers (8 rows a warp), publishes the tile's
totals, waits at one grid-wide barrier and adds the totals of the chunks
before its own; a table larger than the card holds at once goes in waves of
tiles, one barrier each. D gathers and scales its rows in that single read of
the table, writes the scan into an [S+1, L] scratch and, after one more
barrier, reads the boundary rows in the same launch. The scan is taken once
per launch and the last addition repeated ``reps`` times. Its order of
additions is fixed (``scan_order_plain`` restates it), so a launch gives the
same bits on every run. A tensor on the CPU takes the plain PyTorch version; a
CUDA tensor launches the kernel or raises.

Tolerances: the gathers add the same f32 values in the same order as their
plain versions and are equal bit for bit. A scan's element is a sum of up to S
terms whose rounding depends on the order of the additions (``scan_order_plain``
here, the library's own order in ``torch.cumsum``). A scan that
adds row after row makes S roundings of up to half an f32 epsilon of |cs|
each, which add up like a random walk to about √S/2 · epsilon · max|cs|; C
and D are held to twice that, √S · epsilon · max|cs|, per addition of ``reps``
(``scan_tolerance``). D's boundary difference cancels, which makes the error
absolute in the size of the prefix and not relative to the result.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.device import cuda_ms

LANES = 128  # table width of the script


def make_inputs(s: int, seed: int = 0, device: str | torch.device = "cpu") -> dict:
    """The script's inputs (exp_pallas_taa.py:47-57) from ``seed``: the table
    [s, 128], sorted row ids [s, 1], coefficients [s, 1] in [0, 1), and the
    segment boundaries begin/end [s, 1] of ``rows_sorted`` [s] (segment r holds
    the positions whose sorted row is r)."""
    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((s, LANES)).astype(np.float32)
    ids = np.sort(rng.integers(0, s, s)).astype(np.int32)[:, None]
    coef = rng.random((s, 1), dtype=np.float32)
    rows_sorted = np.sort(rng.integers(0, s, s)).astype(np.int32)
    begin = np.searchsorted(rows_sorted, np.arange(s)).astype(np.int32)[:, None]
    end = np.searchsorted(rows_sorted, np.arange(s), side="right").astype(np.int32)[:, None]
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("tab", tab), ("ids", ids), ("coef", coef), ("begin", begin), ("end", end),
             ("rows_sorted", rows_sorted))}


def _strided(idx: torch.Tensor, s: int, l: int, strides, k: int) -> torch.Tensor:
    """Step k's [s, l] int64 index view of ``idx`` read through ``strides``."""
    si, sj, sk = strides
    flat = idx.reshape(-1)
    return flat.as_strided((s, l), (si, sj), flat.storage_offset() + k * sk).long()


def _taa_plain(axis: int, idx, strides, tab, steps, reps):
    s, l = tab.shape
    acc = torch.zeros(s, l, dtype=torch.float32, device=tab.device)
    for _ in range(reps):
        for k in range(steps):
            acc = acc + torch.take_along_dim(tab, _strided(idx, s, l, strides, k), axis).float()
    return acc


def taa_rows_plain(idx, strides, tab, steps: int = 1, reps: int = 1) -> torch.Tensor:
    """Plain version of ``taa_rows``: ``take_along_dim`` along axis 0, step by
    step and rep by rep from zero, in f32."""
    return _taa_plain(0, idx, strides, tab, steps, reps)


def taa_lanes_plain(idx, strides, tab, steps: int = 1, reps: int = 1) -> torch.Tensor:
    """Plain version of ``taa_lanes``: the same along axis 1."""
    return _taa_plain(1, idx, strides, tab, steps, reps)


def taa_rows(idx, strides, tab, steps: int = 1, reps: int = 1) -> torch.Tensor:
    """out[i, j] = Σ_{r<reps} Σ_{k<steps} tab[idx[i·si + j·sj + k·sk], j], [S, L] f32."""
    if tab.device.type == "cpu":
        return taa_rows_plain(idx, strides, tab, steps, reps)
    return kernels.taa_rows(idx, strides, tab, steps, reps)


def taa_lanes(idx, strides, tab, steps: int = 1, reps: int = 1) -> torch.Tensor:
    """out[i, j] = Σ_{r<reps} Σ_{k<steps} tab[i, idx[i·si + j·sj + k·sk]], [S, L] f32."""
    if tab.device.type == "cpu":
        return taa_lanes_plain(idx, strides, tab, steps, reps)
    return kernels.taa_lanes(idx, strides, tab, steps, reps)


def taa_probe(ids, tab, reps: int = 1) -> torch.Tensor:
    """Probe A2: Σ_{r<reps} tab[ids[i]] per row, ids [S, 1] broadcast over the lanes."""
    return taa_rows(ids, (1, 0, 0), tab, 1, reps)


def taa_probe_plain(ids, tab, reps: int = 1) -> torch.Tensor:
    return taa_rows_plain(ids, (1, 0, 0), tab, 1, reps)


def _repeat_add(x: torch.Tensor, reps: int) -> torch.Tensor:
    acc = torch.zeros_like(x)
    for _ in range(reps):
        acc = acc + x
    return acc


def cumsum_probe_plain(tab, reps: int = 1) -> torch.Tensor:
    """Plain version of probe C: ``torch.cumsum`` once, added ``reps`` times."""
    return _repeat_add(torch.cumsum(tab.float(), 0), reps)


def cumsum_probe(tab, reps: int = 1) -> torch.Tensor:
    """Probe C: Σ_{r<reps} cumsum(tab, axis 0), [S, L] f32."""
    if tab.device.type == "cpu":
        return cumsum_probe_plain(tab, reps)
    return kernels.cumsum_cols(tab, reps)


def scan_order_plain(vals) -> torch.Tensor:
    """The inclusive column scan of ``vals`` [S, L] f32 in the kernels' order of
    additions, restated with tensor operations: rows padded with zeros to
    chunks of ``kernels.SCAN_CHUNK_ROWS``, each chunk cut into runs of
    ``SCAN_WARP_ROWS`` (a warp's); each run scanned row after row; each run
    after the first of a chunk given the totals of the runs before it, added
    in order; then each chunk given the left fold from 0 of the totals of the
    chunks before it. Every addition is one f32 addition of the kernels, so on
    the same inputs the kernels' scan equals this bit for bit."""
    s, l = vals.shape
    rows, runs = kernels.SCAN_CHUNK_ROWS, kernels.SCAN_CHUNK_ROWS // kernels.SCAN_WARP_ROWS
    chunks = -(-s // rows)
    x = vals.new_zeros(chunks * rows, l)
    x[:s] = vals
    x = x.view(chunks, runs, kernels.SCAN_WARP_ROWS, l)
    scan = x.clone()
    for u in range(1, kernels.SCAN_WARP_ROWS):
        scan[:, :, u] = scan[:, :, u - 1] + x[:, :, u]
    total = scan[:, 0, -1].clone()
    runs_scan = scan.clone()
    for w in range(1, runs):
        runs_scan[:, w] = total[:, None] + scan[:, w]
        total = total + scan[:, w, -1]
    off = torch.zeros_like(total)
    fold = torch.zeros_like(total[0])
    for c in range(chunks):
        off[c] = fold
        fold = fold + total[c]
    return (off[:, None, None] + runs_scan).reshape(chunks * rows, l)[:s]


def piece_scan(ids, coef, tab) -> torch.Tensor:
    """[0; cumsum(tab[ids]·coef, axis 0)], [S+1, L]: the scan that probe D reads
    at its boundaries (plain tensor operations)."""
    vals = tab[ids.reshape(-1).long()] * coef.reshape(-1, 1)
    return torch.cat([torch.zeros_like(vals[:1]), torch.cumsum(vals, 0)])


def piece_probe_plain(ids, coef, begin, end, tab, reps: int = 1) -> torch.Tensor:
    """Plain version of probe D: gather, scale, ``torch.cumsum`` with a leading
    zero row, and the two boundary reads."""
    cs = piece_scan(ids, coef, tab)
    return _repeat_add(cs[end.reshape(-1).long()] - cs[begin.reshape(-1).long()], reps)


def piece_probe(ids, coef, begin, end, tab, reps: int = 1) -> torch.Tensor:
    """Probe D: Σ_{r<reps} (cs[end] − cs[begin]), [S, L] f32."""
    if tab.device.type == "cpu":
        return piece_probe_plain(ids, coef, begin, end, tab, reps)
    return kernels.piece(ids, coef, begin, end, tab, reps)


def gather_segment_library(ids, coef, rows_sorted, tab) -> torch.Tensor:
    """The library version of one piece (the script's "XLA gather+seg" line,
    :147-151): ``index_select`` · coef, then ``index_add_`` over the sorted rows."""
    vals = tab.index_select(0, ids.reshape(-1)) * coef.reshape(-1, 1)
    return torch.zeros_like(tab).index_add_(0, rows_sorted, vals)


def scan_tolerance(cs_max: float, s: int, reps: int) -> float:
    """Largest |kernel − plain| allowed for probes C and D over ``s`` rows: √s
    times f32 epsilon times max|cs|, for each of the ``reps`` additions."""
    return s ** 0.5 * float(torch.finfo(torch.float32).eps) * cs_max * reps


def run(s: int = 16384, reps: int = 16, iters: int = 5, seed: int = 0) -> dict:
    """Time the probes on the card at the script's shapes. Returns
    {"A2" | "C" | "D" | "X": {"ms", "ns_per_row", "rows"}, "D_check": {...},
    "inputs": ...}. A2 does ``s·reps`` row gathers per launch; C and D scan once
    per launch, X is one gather and segment sum, so theirs are per ``s`` rows."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device and none is available")
    x = make_inputs(s, seed, "cuda")
    tab, ids, coef, begin, end = (x[k] for k in ("tab", "ids", "coef", "begin", "end"))
    res = {"inputs": x, "s": s, "reps": reps}
    for name, fn, rows in (
            ("A2", lambda: taa_probe(ids, tab, reps), s * reps),
            ("C", lambda: cumsum_probe(tab, reps), s),
            ("D", lambda: piece_probe(ids, coef, begin, end, tab, reps), s),
            ("X", lambda: gather_segment_library(ids, coef, x["rows_sorted"].long(), tab), s)):
        ms = cuda_ms(fn, iters)
        res[name] = {"ms": ms, "ns_per_row": ms * 1e6 / rows, "rows": rows}
    # the script's spot check of D (:158-165): one rep against numpy in f64
    tab_n, ids_n, coef_n = (x[k].cpu().numpy() for k in ("tab", "ids", "coef"))
    vals = tab_n[ids_n[:, 0]] * coef_n
    cs = np.concatenate([np.zeros((1, LANES)), np.cumsum(vals.astype(np.float64), 0)])
    want = float((cs[end.cpu().numpy()[:, 0]] - cs[begin.cpu().numpy()[:, 0]]).sum())
    got = float(piece_probe(ids, coef, begin, end, tab, reps).double().sum()) / reps
    res["D_check"] = {"got": got, "want": want,
                      "ok": abs(got - want) < abs(want) * 1e-3 + 1}
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_gcn_torch.probes.taa")
    ap.add_argument("--s", type=int, default=16384, help="rows of the table")
    ap.add_argument("--reps", type=int, default=16, help="in-kernel repeats")
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    res = run(args.s, args.reps, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device={torch.cuda.get_device_name(0)} ({smi}) S={args.s} reps={args.reps}")
    for name, label in (("A2", "A2 TAA row-gather "), ("C", "C  cumsum axis0   "),
                        ("D", "D  full piece TAA "), ("X", "X  lib gather+seg  ")):
        r = res[name]
        print(f"{label}: {r['ms']:.4f} ms = {r['ns_per_row']:.3f} ns/row over {r['rows']} rows")
    c = res["D_check"]
    print(f"D correctness: got {c['got']:.1f} want {c['want']:.1f} "
          f"({'OK' if c['ok'] else 'MISMATCH'})")
    if not c["ok"]:
        raise AssertionError("probe D disagrees with the numpy piece")
    return 0


if __name__ == "__main__":
    sys.exit(main())
