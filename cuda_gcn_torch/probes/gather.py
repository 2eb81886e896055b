"""Probes of random row gathers and per-edge row accumulation on the card.

    python -m cuda_gcn_torch.probes.gather [--rows 16384] [--m 1048576] [--d 128]

The counterpart of scripts/exp_pallas_gather.py, with its defaults. Every
aggregation kernel of the port is made of these two primitives:

* probe A (``gather_kernel``, exp_pallas_gather.py:60-70): out[1, d] =
  Σ_{i<m} h[idx[i]] over ``m`` random row ids of an [rows, d] f32 table;
* probe B (``scatter_kernel``, :85-95): out[idx[i]] += coef[i] · h[i mod rows]
  for i < m_b = min(m, 65536), over sorted idx, into an [rows, d] f32 output
  that starts at zero.

Both kernels are in csrc/gather_probe.cu. Probe A's kernel does not gather:
the sum regroups exactly as Σ_r count[r] · h[r], so it counts the ids (in
shared memory where a table's counts fit a block's, else in device memory;
``kernels.gather_probe_path``), then reads each table row once, times its
count. That reads the 4 MB of ids and the 8 MB table of the defaults once,
which is what the bytes bound counts, where gathering the rows moves 537 MB;
the card's random row gather is timed by kernel 3 and ``taa_rows`` instead.
Probe B's kernel takes idx[:mb] sorted, with ids in [0, rows) (it writes NaN
to all of out otherwise; the plain version sums ids in any order and raises
for one outside the table). It is one cooperative launch: the ids are cut
into tiles of equal numbers of ids (``scatter_split_plain`` restates the cut)
and each row's terms are added in index order, one warp a row; a row with no
id is written 0. A tensor on the CPU takes the plain PyTorch version; a CUDA
tensor launches the kernel or raises. The entry point runs on the card and
prints each kernel's time beside the card's name and power limit, per id for
A (the function's time over its ids, not a rate of row gathers) and per row
for B.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.device import cuda_ms

SCATTER_MAX = 1 << 16  # probe B's bound on its scalar loop (exp_pallas_gather.py:83)


def make_inputs(rows: int, m: int, d: int, seed: int = 0,
                device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """The probes' inputs from ``seed``: the table h [rows, d], m random ids,
    the same ids sorted, and m coefficients in [0, 1)."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((rows, d), dtype=np.float32)
    idx = rng.integers(0, rows, m, dtype=np.int32)
    coef = rng.random(m, dtype=np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("h", h), ("idx", idx), ("idx_sorted", np.sort(idx)), ("coef", coef))}


def gather_probe_plain(idx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of probe A: [1, d] in f32."""
    return h[idx.long()].float().sum(0, keepdim=True)


def gather_probe(idx: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    if h.device.type == "cpu":
        return gather_probe_plain(idx, h)
    return kernels.gather_probe(idx, h)


def scatter_probe_plain(idx: torch.Tensor, coef: torch.Tensor, h: torch.Tensor,
                        mb: int) -> torch.Tensor:
    """Plain version of probe B: [rows, d] in f32, the terms added in index
    order (sorted or not); an id outside [0, rows) raises."""
    rows = h.shape[0]
    i = torch.arange(mb, device=h.device)
    out = torch.zeros(rows, h.shape[1], dtype=torch.float32, device=h.device)
    return out.index_add_(0, idx[:mb].long(), coef[:mb, None] * h[i % rows].float())


def scatter_split_plain(idx, mb: int, rows: int, ctas: int) -> np.ndarray:
    """The work split of probe B's kernel, restated: [tiles, 2] int64 ranges
    [lo, hi) of terms, tiles = max(ctas, ceil(mb / 2048)). The ids are cut
    every ceil(mb / tiles) ids, and each cut moves on to the next row's first
    id: tile t adds the rows whose first id it holds, whole, in order (CTA b
    takes the tiles b, b + ctas, ...). A row with no id is written 0: by the
    tile of the busy row before it, or, before the first id and after the
    last, by the CTAs in even shares."""
    ids = np.asarray(idx[:mb], dtype=np.int64)
    tiles = max(ctas, -(-mb // kernels.SCATTER_TILE_IDS))
    firsts = np.r_[np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]]) if mb else [], mb]
    cuts = np.minimum(np.arange(tiles + 1, dtype=np.int64) * max(1, -(-mb // tiles)), mb)
    at = firsts[np.searchsorted(firsts, cuts)].astype(np.int64)
    return np.stack([at[:-1], at[1:]], axis=1)


def scatter_probe(idx: torch.Tensor, coef: torch.Tensor, h: torch.Tensor,
                  mb: int) -> torch.Tensor:
    if h.device.type == "cpu":
        return scatter_probe_plain(idx, coef, h, mb)
    return kernels.scatter_probe(idx, coef, h, mb)


def run(rows: int = 16384, m: int = 1 << 20, d: int = 128, iters: int = 20,
        seed: int = 0) -> dict:
    """Time both probe kernels on the card at these shapes. Returns
    {"A": {...}, "B": {...}, "inputs": ...} with ms and ns per id (A) or per
    edge (B) under ``ns_per_row``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device and none is available")
    x = make_inputs(rows, m, d, seed, "cuda")
    mb = min(m, SCATTER_MAX)
    res = {"inputs": x, "mb": mb}
    for name, fn, count in (
            ("A", lambda: gather_probe(x["idx"], x["h"]), m),
            ("B", lambda: scatter_probe(x["idx_sorted"], x["coef"], x["h"], mb), mb)):
        ms = cuda_ms(fn, iters)
        res[name] = {"ms": ms, "ns_per_row": ms * 1e6 / count, "rows": count}
    return res


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="cuda_gcn_torch.probes.gather")
    ap.add_argument("--rows", type=int, default=16384, help="table rows")
    ap.add_argument("--m", type=int, default=1 << 20, help="gathered rows/edges")
    ap.add_argument("--d", type=int, default=128, help="feature width")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.rows, args.m, args.d, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"device={torch.cuda.get_device_name(0)} ({smi}) table=[{args.rows},{args.d}] "
          f"m={args.m}")
    a, b = res["A"], res["B"]
    print(f"A gather-sum: {a['ms']:.4f} ms = {a['ns_per_row']:.3f} ns/id over {a['rows']} ids "
          f"(the function's time per id, not a gather rate: the kernel counts the ids and "
          f"reads each table row once)")
    print(f"B scatter+=: {b['ms']:.4f} ms = {b['ns_per_row']:.3f} ns/row over {b['rows']} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
