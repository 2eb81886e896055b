"""Device graph: the normalized adjacency Â = D^-1/2 (A+I) D^-1/2, built once.

The port's counterpart of cuda_gcn_tpu/data/graph.py ``build_graph``, with the
same arguments and the same tile selection, so the same CSR gives the same
tiles, tile ids and residual edges. Host work is numpy; the tiles are
scattered straight into a tensor on the target device (numpy has no bf16, and
a host f32 copy of the reddit tiles would be 5.75 GB).

Layouts per backend:

* ``dense``   — Â as a dense [n, n] f32 tensor (small graphs).
* ``segment`` — every edge in the residual CSR (kernel 2, ops/residual.py).
* ``bsr``     — the densest [tb, tb] tiles of Â as dense blocks (kernel 1,
  ops/bsr.py) plus the remaining edges as residual CSR (kernel 2).
* ``ell``, ``pallas`` — Â in the bucketed ELL packing of
  cuda_gcn_tpu/data/graph.py:475-539 (same buckets, bucket order and pads),
  flattened into an ``EllPlan`` for kernel 3 (ops/ell.py); the transpose packing
  only for an asymmetric Â. No residual CSR is built for them.

At ``NATIVE_BUILD_MIN_NNZ`` edges and more, as in the JAX package
(cuda_gcn_tpu/data/graph.py:448-472,526-531,838-847), the normalization, the
stable transposes and the tile selection run in the native build steps of
data/native_build.py, bit for bit with the numpy code below them, which stays
the oracle; the symmetry and uniqueness sorts stay numpy in both packages.
``Graph.build_s`` holds the host seconds of each step of the build.

The edge coefficients of the residual CSR and of the ELL plan are stored in
bf16 when the activations are (``act_itemsize=2``), as the JAX package stores
its residual's (cuda_gcn_tpu/data/graph.py:621): half the bytes of every slot's
value, rounded to nearest even once at build time. The dense ``adj`` stays f32
and is cast to the activation type where it is used (ops/graphsum.py), as in
the JAX package.

Not ported: the flat bucketed piece layout ``Blocked2DDev``
(cuda_gcn_tpu/data/graph.py:114-433). It works around TPU gather and
segment-sum costs; on the GPU the residual is plain CSR, cut into work items
of at most 256 edges with one warp each, which sums the same edges.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from cuda_gcn_torch.data import native_build
from cuda_gcn_torch.data.dataset import CSR
from cuda_gcn_torch.device import resolve_device
from cuda_gcn_torch.ops.bsr import TilePlan, tile_plan
from cuda_gcn_torch.ops.ell import (EdgeMap, EllBucket, EllPlan, WorkList, csr_work_list,
                                    ell_plan, pick_order)

# 'auto' backend: dense below this node count, block-sparse tiles above
# (cuda_gcn_tpu/data/graph.py:544).
DENSE_BACKEND_MAX_NODES = 8192
BSR_DEFAULT_TILE = 256
BSR_DEFAULT_DTYPE = "bfloat16"
# Tile break-even from the JAX package (cuda_gcn_tpu/data/graph.py:554-558).
# It was calibrated on a TPU; it is kept so that both packages select the same
# tiles. Re-deriving it for the H100 is a ROADMAP item.
BSR_BREAK_EVEN_BYTES_PER_EDGE = 2048
# At this many edges and more the native build steps take the host's hot loops
# (cuda_gcn_tpu/data/graph.py:451); below it the numpy code runs.
NATIVE_BUILD_MIN_NNZ = 2_000_000

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class ResidualCSR:
    """Edges as CSR on the device: out[i] += coef[e] * h[cols[e]] for e in row i."""

    row_ptr: torch.Tensor  # (n+1,) int32
    cols: torch.Tensor     # (m,) int32
    coef: torch.Tensor     # (m,) float32, or bfloat16 for bf16 activations
    work: WorkList         # kernel 2's work items over the rows (ops/ell.py)

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])


@dataclasses.dataclass
class Graph:
    """Device-resident normalized adjacency in the layouts of one backend."""

    n_nodes: int
    backend: str             # 'dense' | 'segment' | 'bsr' | 'ell' | 'pallas'
    symmetric: bool          # Â = Âᵀ: the backward runs on the forward structures
    total_nnz: int           # nnz of Â including tile-covered edges
    resid: ResidualCSR | None = None    # forward residual ('segment', 'bsr')
    resid_t: ResidualCSR | None = None  # transpose residual (asymmetric only)
    adj: torch.Tensor | None = None     # dense [n, n] ('dense')
    tiles: torch.Tensor | None = None   # [K, tb, tb] ('bsr')
    tile_rows: torch.Tensor | None = None  # (K,) int32 block rows, sorted
    tile_cols: torch.Tensor | None = None  # (K,) int32 block cols
    tb: int = 0
    t_blocks: int = 0
    plan: TilePlan | None = None    # tiles grouped by block row (forward)
    plan_t: TilePlan | None = None  # tiles grouped by block col (asymmetric)
    ell: EllPlan | None = None      # ELL packing of Â ('ell', 'pallas')
    ell_t: EllPlan | None = None    # ELL packing of Âᵀ (asymmetric only)
    edge_map: EdgeMap | None = None  # the GAT's reverse-edge map (ops/ell.py ``edge_map``)
    build_s: dict = dataclasses.field(default_factory=dict)  # host seconds by build step

    @property
    def num_tiles(self) -> int:
        return 0 if self.tiles is None else int(self.tiles.shape[0])

    @property
    def resid_nnz(self) -> int:
        return 0 if self.resid is None else self.resid.nnz


def normalization_coefficients(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-edge Â values 1/sqrt(rowlen(src) * rowlen(dst)) (module.cpp:91-93),
    row lengths including the prepended self-loop."""
    if int(indptr[-1]) >= NATIVE_BUILD_MIN_NNZ:
        return native_build.norm_coef(indptr, indices)
    deg = np.diff(indptr).astype(np.float64)
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return (1.0 / np.sqrt(deg[src] * deg[indices])).astype(np.float32)


def device_memory_bytes(device: torch.device) -> int:
    """Free memory on ``device``: the card's free bytes, or for the CPU half
    of the host's available RAM."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    try:
        return max(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 2,
                   1 << 30)
    except (ValueError, OSError):
        return 4 << 30


def auto_tile_budget(n: int, total_nnz: int, aux_bytes: int, mem_bytes: int,
                     symmetric: bool = False, act_itemsize: int = 4) -> int:
    """Tile budget = device memory minus the run's other residents, by the
    formula of cuda_gcn_tpu/data/graph.py:762-789: ``aux_bytes`` (features),
    four [n, 128] activations, the residual at full nnz (one direction when
    symmetric) and 1 GB of headroom; at least 1 GB."""
    act_bytes = 4 * n * 128 * act_itemsize
    directions = 1 if symmetric else 2
    resid_bytes = int(directions * (4 + act_itemsize) * total_nnz * 1.10)
    budget = mem_bytes - aux_bytes - act_bytes - resid_bytes - (1 << 30)
    return max(budget, 1 << 30)


def _min_edges(tb: int, itemsize: int, min_edges: int | None) -> int:
    return min_edges or max(tb * tb * itemsize // BSR_BREAK_EVEN_BYTES_PER_EDGE, 8)


def resolve_tile_budget(n: int, nnz: int, tb: int, itemsize: int,
                        min_edges: int | None, aux_bytes: int, symmetric: bool,
                        act_itemsize: int, device: torch.device) -> int:
    """1 GB when every candidate tile fits in it (no device query), else
    ``auto_tile_budget`` from the device's free memory
    (cuda_gcn_tpu/data/graph.py:738-759)."""
    tiles_ub_bytes = (nnz // _min_edges(tb, itemsize, min_edges) + 1) * tb * tb * itemsize
    if tiles_ub_bytes <= (1 << 30):
        return 1 << 30
    budget = auto_tile_budget(n, nnz, aux_bytes, device_memory_bytes(device),
                              symmetric=symmetric, act_itemsize=act_itemsize)
    logging.getLogger(__name__).info("auto tile budget: %.2f GB", budget / (1 << 30))
    return budget


def _select_tile_ids(src, dst, n, tb, min_edges, budget_bytes, itemsize):
    """Sorted ids (row * T + col) of the densest [tb, tb] tiles: every tile
    with at least ``min_edges`` edges, cut densest-first to the budget
    (cuda_gcn_tpu/data/graph.py:823-858)."""
    t_blocks = -(-n // tb)
    max_tiles = max(int(budget_bytes // (tb * tb * itemsize)), 0)
    tile_id = (src // tb) * t_blocks + dst // tb
    counts = np.bincount(tile_id, minlength=t_blocks * t_blocks)
    candidates = np.flatnonzero(counts >= _min_edges(tb, itemsize, min_edges))
    if len(candidates) > max_tiles:
        order = np.argsort(-counts[candidates], kind="stable")
        candidates = candidates[order[:max_tiles]]
    return np.sort(candidates), tile_id, t_blocks


def _select_tiles(src, dst, n, tb, min_edges, budget_bytes, itemsize, symmetric):
    """(ids, edge rank, T): the tiles that ``build_graph`` makes, sorted ids
    as ``_select_tile_ids`` gives them, pair-closed when ``symmetric``, and
    each edge's rank among them (-1: the residual keeps the edge)."""
    t_blocks = -(-n // tb)
    if len(src) >= NATIVE_BUILD_MIN_NNZ:
        max_tiles = max(int(budget_bytes // (tb * tb * itemsize)), 0)
        ids, rank = native_build.select_tiles(src, dst, n, tb,
                                              _min_edges(tb, itemsize, min_edges),
                                              max_tiles, symmetric)
        return ids, rank, t_blocks
    candidates, tile_id, _ = _select_tile_ids(src, dst, n, tb, min_edges, budget_bytes,
                                              itemsize)
    if symmetric and len(candidates):
        candidates = _pair_close(candidates, t_blocks)
    rank_of = np.full(t_blocks * t_blocks, -1, dtype=np.int64)
    rank_of[candidates] = np.arange(len(candidates))
    return candidates, rank_of[tile_id], t_blocks


def _pair_close(candidates: np.ndarray, t_blocks: int) -> np.ndarray:
    """Drop off-diagonal tiles whose mirror did not survive the budget cut, so
    a symmetric Â keeps a symmetric residual (cuda_gcn_tpu/data/graph.py:801-820)."""
    mirror = (candidates % t_blocks) * t_blocks + candidates // t_blocks
    return candidates[np.isin(mirror, candidates, assume_unique=True)]


def _materialize_tiles(k, tb, flat, values, dtype, unique_edges, device):
    """Scatter edge values into [k, tb, tb] tiles on ``device``. Unique edges
    assign straight into the target dtype (torch's f32->bf16 cast rounds to
    nearest even, as ml_dtypes does); repeated edges accumulate in f32 first."""
    idx = torch.from_numpy(flat).to(device)
    vals = torch.from_numpy(values).to(device)
    if unique_edges:
        tiles = torch.zeros(k * tb * tb, dtype=dtype, device=device)
        tiles[idx] = vals.to(dtype)
    else:
        acc = torch.zeros(k * tb * tb, dtype=torch.float32, device=device)
        acc.index_put_((idx,), vals, accumulate=True)
        tiles = acc.to(dtype)
    return tiles.view(k, tb, tb)


def _ell_widths(deg: np.ndarray) -> np.ndarray:
    """ELL bucket width per row (cuda_gcn_tpu/data/graph.py:475-483): multiples
    of 8 up to degree 64, multiples of 64 up to 512, powers of two above."""
    d = np.maximum(deg, 1)
    pow2 = (2 ** np.ceil(np.log2(d))).astype(np.int64)
    return np.where(d <= 64, ((d + 7) // 8) * 8,
                    np.where(d <= 512, ((d + 63) // 64) * 64, pow2)).astype(np.int64)


def _ell_pack(rows_sorted: np.ndarray, deg: np.ndarray, col_of: np.ndarray,
              coef_of: np.ndarray, indptr: np.ndarray) -> list[EllBucket]:
    """Bucket rows by width class; pad each bucket's rows to the bucket width
    with col 0, coef 0 (cuda_gcn_tpu/data/graph.py:486-513)."""
    buckets: list[EllBucket] = []
    if len(rows_sorted) == 0:
        return buckets
    bucket_id = _ell_widths(deg[rows_sorted])
    for b in np.unique(bucket_id):
        sel = rows_sorted[bucket_id == b]
        width = int(b)
        r = len(sel)
        cols = np.zeros((r, width), dtype=np.int32)
        coef = np.zeros((r, width), dtype=np.float32)
        # flat slot index = bucket_row * width + within-row slot
        deg_sel = deg[sel].astype(np.int64)
        lo = indptr[sel].astype(np.int64)
        total = int(deg_sel.sum())
        if total:
            rep_row = np.repeat(np.arange(r, dtype=np.int64), deg_sel)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(deg_sel) - deg_sel, deg_sel)
            edge_idx = np.repeat(lo, deg_sel) + within
            flat = rep_row * width + within
            cols.reshape(-1)[flat] = col_of[edge_idx]
            coef.reshape(-1)[flat] = coef_of[edge_idx]
        buckets.append(EllBucket(rows=sel.astype(np.int32), cols=cols, coef=coef,
                                 width=width))
    return buckets


def build_ell(indptr: np.ndarray, indices: np.ndarray, coef: np.ndarray) -> list[EllBucket]:
    """ELL buckets of a CSR, rows ordered by degree (stable)."""
    deg = np.diff(indptr)
    return _ell_pack(np.argsort(deg, kind="stable"), deg, indices, coef, indptr)


def _transpose_coo(src, dst, coef, n):
    """The edges ordered stably by ``dst``, as (dst, src, coef): Âᵀ's COO."""
    if len(src) >= NATIVE_BUILD_MIN_NNZ:
        return native_build.transpose_coo(src, dst, coef, n)
    perm = np.argsort(dst, kind="stable")
    return dst[perm], src[perm], coef[perm]


def _coo_to_csr(rows_sorted: np.ndarray, n: int) -> np.ndarray:
    """indptr from row ids that are already sorted ascending."""
    counts = np.bincount(rows_sorted, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def _ell_plan_of(indptr, indices, coef, device, coef_dtype) -> EllPlan:
    return ell_plan(build_ell(indptr, indices.astype(np.int32), coef), np.diff(indptr),
                    device, order=pick_order(indptr, indices), coef_dtype=coef_dtype)


def _residual_csr(rows, cols, coef, n, device,
                  coef_dtype=torch.float32) -> ResidualCSR:
    """CSR over edges whose ``rows`` are sorted ascending."""
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    if row_ptr[-1] >= 2**31:
        raise ValueError(f"{row_ptr[-1]} residual edges exceed int32 CSR offsets")
    return ResidualCSR(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(device),
        cols=torch.from_numpy(cols.astype(np.int32)).to(device),
        coef=torch.from_numpy(np.ascontiguousarray(coef, dtype=np.float32)).to(
            device=device, dtype=coef_dtype),
        work=csr_work_list(row_ptr, device))


def build_graph(csr: CSR, backend: str = "auto", bsr_tile: int = BSR_DEFAULT_TILE,
                bsr_min_edges: int | None = None,
                bsr_budget_bytes: int | None = None,
                bsr_dtype: str = BSR_DEFAULT_DTYPE, aux_bytes: int = 0,
                act_itemsize: int = 4,
                device: str | torch.device | None = None) -> Graph:
    """Build the device Graph from an adjacency CSR (self-loops included).

    Arguments as in cuda_gcn_tpu/data/graph.py:561-567 (less ``with_ell``,
    since only the ``ell``/``pallas`` backends read the ELL packing here, and
    ``blocked_*``, whose layout is not ported), plus ``device``.
    ``bsr_budget_bytes=None`` sizes the tile budget from the device's free
    memory (resolve_tile_budget), counting activations of ``act_itemsize``
    bytes; ``act_itemsize=2`` also stores the edge coefficients in bf16."""
    device = resolve_device(device)
    n = csr.nrows
    if backend == "auto":  # the GCN's choice (models/gcn.py ``GraphModel.graph_backend``)
        from cuda_gcn_torch.models.gcn import GCN

        backend = GCN.graph_backend(backend, n)
    if backend not in ("dense", "segment", "bsr", "ell", "pallas"):
        raise ValueError(f"unknown graphsum backend {backend!r}")
    steps: dict[str, float] = {}
    t0 = time.perf_counter()

    def lap(step: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        steps[step] = t1 - t0
        t0 = t1

    indptr = csr.indptr.astype(np.int64)
    dst = csr.indices.astype(np.int64)
    coef = normalization_coefficients(indptr, dst)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    lap("coef")

    # symmetry of the edge pattern, and whether any edge is listed twice
    fwd_sorted = np.sort(src * n + dst)
    symmetric = bool(np.array_equal(fwd_sorted, np.sort(dst * n + src)))
    unique_edges = not bool(np.any(fwd_sorted[1:] == fwd_sorted[:-1]))
    del fwd_sorted
    lap("pattern")

    graph = Graph(n_nodes=n, backend=backend, symmetric=symmetric,
                  total_nnz=int(csr.nnz), build_s=steps)
    coef_dtype = torch.bfloat16 if act_itemsize == 2 else torch.float32
    if backend == "dense":
        adj = np.zeros((n, n), dtype=np.float32)
        np.add.at(adj, (src, dst), coef)
        graph.adj = torch.from_numpy(adj).to(device)
        lap("dense")
        return graph

    if backend in ("ell", "pallas"):
        graph.ell = _ell_plan_of(indptr, dst, coef, device, coef_dtype)
        lap("ell")
        if not symmetric:
            t_src, t_dst, t_coef = _transpose_coo(src, dst, coef, n)
            lap("transpose")
            graph.ell_t = _ell_plan_of(_coo_to_csr(t_src, n), t_dst, t_coef, device,
                                       coef_dtype)
            lap("ell_t")
        return graph

    if backend == "bsr":
        tdtype = _TORCH_DTYPES[bsr_dtype]
        itemsize = torch.empty(0, dtype=tdtype).element_size()
        if bsr_budget_bytes is None:
            bsr_budget_bytes = resolve_tile_budget(
                n, len(src), bsr_tile, itemsize, bsr_min_edges, aux_bytes,
                symmetric, act_itemsize, device)
        ids, edge_rank, t_blocks = _select_tiles(src, dst, n, bsr_tile, bsr_min_edges,
                                                 bsr_budget_bytes, itemsize, symmetric)
        in_tile = edge_rank >= 0
        lap("select")
        k, tb = len(ids), bsr_tile
        flat = (edge_rank[in_tile].astype(np.int64, copy=False) * tb * tb
                + (src[in_tile] % tb) * tb + dst[in_tile] % tb)
        del edge_rank
        graph.tiles = _materialize_tiles(k, tb, flat, coef[in_tile], tdtype,
                                         unique_edges, device)
        del flat
        graph.tile_rows = torch.from_numpy((ids // t_blocks).astype(np.int32)).to(device)
        graph.tile_cols = torch.from_numpy((ids % t_blocks).astype(np.int32)).to(device)
        graph.tb, graph.t_blocks = tb, t_blocks
        graph.plan = tile_plan(graph.tile_rows, graph.tile_cols, t_blocks)
        if not symmetric:
            graph.plan_t = tile_plan(graph.tile_cols, graph.tile_rows, t_blocks)
        lap("tiles")
        keep = ~in_tile
        src, dst, coef = src[keep], dst[keep], coef[keep]
        lap("residual_edges")

    graph.resid = _residual_csr(src, dst, coef, n, device, coef_dtype)
    lap("residual")
    if not symmetric:
        # Âᵀ as CSR: the same edges ordered by column, stably
        t_src, t_dst, t_coef = _transpose_coo(src, dst, coef, n)
        lap("transpose")
        graph.resid_t = _residual_csr(t_src, t_dst, t_coef, n, device, coef_dtype)
        lap("residual_t")
    return graph
