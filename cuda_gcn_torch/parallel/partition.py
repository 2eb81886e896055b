"""Graph partitioner: a 1-D node-block partition of Â with halo-exchange metadata.

The port's numpy copy of cuda_gcn_tpu/parallel/partition.py (which it cannot
import). Nodes are cut into P contiguous ranges, one per rank; rank p owns
the CSR rows of its range. Edges whose destination lies in another part need
that part's activations: the halo. Everything is computed on the host:

* each part's local edges, rows rebased into the part;
* send lists bucketed by ring offset: the exchange runs as P-1 rounds, round k
  shipping rank q's rows to (q+k) % P, each round's buffer sized to the most
  any rank needs at that offset (``hmax_k``);
* destinations remapped into the local space ``[own block (B) | halo (sum hmax_k)]``;
* the same edges split into interior (destination in the own block) and
  boundary (destination in the halo) operators, so that the exchange can fly
  while the interior is aggregated; with ``interior_tiles`` the densest
  [tb, tb] blocks of each interior become dense tiles (kernel 1) and the
  interior arrays keep only the residual.

Every index array equals the JAX package's bit for bit, padding included
(tests/test_torch_partition.py). What differs: the full local COO and its
transpose (``src``/``t_src`` and kin) are not stored, since every device
operator is built from the interior and boundary split; the tiles are not stacked into
a host array of [P, Kmax, tb, tb] but kept as each part's scatter of edge
values (``part(p).tiles(device)`` builds one part's tiles on its device), and
the JAX package's flat piece layout of the interior residual
(``_stack_blocked2d``, :130) is not built: on the card the residual is a CSR
with a work list (``PartView`` → parallel/sharded.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_gcn_torch.data.dataset import CSR
from cuda_gcn_torch.data.graph import (_TORCH_DTYPES, BSR_DEFAULT_DTYPE, BSR_DEFAULT_TILE,
                                       _materialize_tiles, _select_tile_ids,
                                       normalization_coefficients, resolve_tile_budget)


@dataclasses.dataclass
class PartView:
    """One part's share of a PartitionedGraph, numpy and without padding
    edges: what one rank puts on its device (parallel/sharded.py
    ``make_sharded_inputs``). Edge lists are (rows, cols, coef), rows sorted."""

    rank: int
    n_parts: int
    block: int
    start: int                 # first global node id of the part
    span: int                  # real nodes of the part (<= block)
    halo_space: int
    hmax_k: tuple
    send_secs: list            # P-1 arrays [hmax_k] int32: block-local rows shipped in round k
    interior: tuple            # residual interior edges, [0, B) x [0, B)
    interior_t: tuple          # their transpose
    boundary: tuple            # [0, B) x [0, halo_space)
    boundary_t: tuple          # [0, halo_space) x [0, B)
    tile_flat: np.ndarray | None = None   # flat index of each tile edge into [K, tb, tb]
    tile_vals: np.ndarray | None = None   # its value (f32)
    tile_rows: np.ndarray | None = None   # (K,) int32 block rows, sorted
    tile_cols: np.ndarray | None = None   # (K,) int32 block cols
    tile_unique: bool = True
    tb: int = 0
    nblocks: int = 0
    tile_dtype: str = BSR_DEFAULT_DTYPE

    @property
    def num_tiles(self) -> int:
        return 0 if self.tile_rows is None else len(self.tile_rows)

    def tiles(self, device) -> torch.Tensor:
        """The part's [K, tb, tb] tiles on ``device``."""
        return _materialize_tiles(self.num_tiles, self.tb, self.tile_flat, self.tile_vals,
                                  _TORCH_DTYPES[self.tile_dtype], self.tile_unique,
                                  torch.device(device))


@dataclasses.dataclass
class PartitionedGraph:
    """Host-side (numpy) stacked per-part arrays; leading axis = part
    (cuda_gcn_tpu/parallel/partition.py:40-127, less the piece layout).

    Parts own variable node ranges ``[starts[p], starts[p+1])``; every part's
    slab is padded to ``block`` = the longest range. ``pad_nodes`` lays a
    global per-node array out as the stacked [P*block] slab."""

    n_parts: int
    block: int
    n_nodes: int
    starts: np.ndarray      # (P,) int64 first global node id of each part
    send_secs: list         # P-1 arrays [P, hmax_k] int32
    hmax_k: tuple
    off_start: np.ndarray   # (P,) int64 section starts (cumsum of hmax_k)
    halo_space: int         # halo rows per part (>= 1)
    i_src: np.ndarray       # [P, Eimax] interior (residual with tiles), sorted
    i_dst: np.ndarray
    i_coef: np.ndarray
    it_src: np.ndarray      # [P, Eimax] transpose, sorted
    it_dst: np.ndarray
    it_coef: np.ndarray
    b_src: np.ndarray       # [P, Ebmax] boundary, sorted; dst halo-local
    b_dst: np.ndarray
    b_coef: np.ndarray
    bt_src: np.ndarray      # [P, Ebmax] transpose, sorted
    bt_dst: np.ndarray
    bt_coef: np.ndarray
    eimax: int
    ebmax: int
    i_counts: np.ndarray    # (P,) real interior (residual) edges of each part
    b_counts: np.ndarray    # (P,) real boundary edges of each part
    # dense tiles of each part's square interior (tb = 0: none)
    i_tile_rows: np.ndarray | None = None   # [P, Kmax] block rows, sorted, padded
    i_tile_cols: np.ndarray | None = None   # [P, Kmax]
    i_tile_counts: np.ndarray | None = None  # (P,) real tiles of each part
    i_tile_flat: list | None = None         # per part: flat index of each tile edge
    i_tile_vals: list | None = None         # per part: its value (f32)
    i_tile_unique: list | None = None       # per part: no edge repeated
    tb: int = 0
    i_nblocks: int = 0
    tile_dtype: str = BSR_DEFAULT_DTYPE

    @property
    def padded_nodes(self) -> int:
        return self.n_parts * self.block

    @property
    def bounds(self) -> np.ndarray:
        """(P+1,) part node-range boundaries (starts and n_nodes)."""
        return np.append(self.starts, self.n_nodes)

    def pad_nodes(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """A global per-node array as the stacked [P*block] slab: part p's
        rows at [p*block, p*block + span_p), ``fill`` elsewhere (-1 for truth
        vectors, so that padding rows stay masked)."""
        out = np.full((self.padded_nodes,) + arr.shape[1:], fill, dtype=arr.dtype)
        b = self.bounds
        for p in range(self.n_parts):
            lo, hi = int(b[p]), int(b[p + 1])
            out[p * self.block: p * self.block + (hi - lo)] = arr[lo:hi]
        return out

    def part(self, p: int) -> PartView:
        """Part ``p``'s arrays without the padding edges (coefficient 0, they
        add exact zeros) and without the padding tiles (all zero)."""
        ki, kb = int(self.i_counts[p]), int(self.b_counts[p])
        lo, hi = (int(v) for v in self.bounds[p:p + 2])
        view = PartView(
            rank=p, n_parts=self.n_parts, block=self.block, start=lo, span=hi - lo,
            halo_space=self.halo_space, hmax_k=self.hmax_k,
            send_secs=[sec[p] for sec in self.send_secs],
            interior=(self.i_src[p, :ki], self.i_dst[p, :ki], self.i_coef[p, :ki]),
            interior_t=(self.it_src[p, :ki], self.it_dst[p, :ki], self.it_coef[p, :ki]),
            boundary=(self.b_src[p, :kb], self.b_dst[p, :kb], self.b_coef[p, :kb]),
            boundary_t=(self.bt_src[p, :kb], self.bt_dst[p, :kb], self.bt_coef[p, :kb]),
            tile_dtype=self.tile_dtype)
        if self.tb:
            k = int(self.i_tile_counts[p])
            view.tile_flat, view.tile_vals = self.i_tile_flat[p], self.i_tile_vals[p]
            view.tile_rows, view.tile_cols = self.i_tile_rows[p, :k], self.i_tile_cols[p, :k]
            view.tile_unique, view.tb, view.nblocks = (self.i_tile_unique[p], self.tb,
                                                       self.i_nblocks)
        return view


def partition_cuts(indptr: np.ndarray, n_parts: int, balance: str = "edges",
                   cluster_sizes: np.ndarray | None = None,
                   snap_slack_frac: float = 0.08) -> np.ndarray:
    """The P part-start node ids (cuda_gcn_tpu/parallel/partition.py:176-227).

    ``balance='nodes'``: equal node blocks. ``'edges'``: cuts at the edge-count
    quantiles, each snapped to the nearest cluster boundary of
    ``cluster_sizes`` when that moves fewer than ``snap_slack_frac`` of a
    part's edges; cuts are then made strictly increasing, every part keeping
    at least one node."""
    n = len(indptr) - 1
    if n < n_parts:
        raise ValueError(f"cannot cut {n} nodes into {n_parts} parts")
    if balance == "nodes" or n_parts == 1:
        block = -(-n // n_parts)
        return np.arange(n_parts, dtype=np.int64) * block
    cum = indptr.astype(np.int64)  # indptr is the cumulative edge count
    m = int(cum[-1])
    targets = (np.arange(1, n_parts) * m) // n_parts
    interior = np.searchsorted(cum, targets, side="left").astype(np.int64)
    if cluster_sizes is not None and len(cluster_sizes) > 1:
        bnds = np.cumsum(np.asarray(cluster_sizes, dtype=np.int64))[:-1]
        slack = snap_slack_frac * m / n_parts
        snapped = []
        for c in interior:
            j = int(np.searchsorted(bnds, c))
            cands = [int(bnds[k]) for k in (j - 1, j) if 0 <= k < len(bnds)]
            best = min(cands, key=lambda b: abs(int(cum[b]) - int(cum[c])),
                       default=int(c))
            snapped.append(best if abs(int(cum[best]) - int(cum[c])) <= slack
                           else int(c))
        interior = np.asarray(snapped, dtype=np.int64)
    interior = np.clip(interior, 1, n - 1)
    interior = np.maximum.accumulate(interior)
    for i in range(1, len(interior)):  # a repeated cut would leave a part empty
        if interior[i] <= interior[i - 1]:
            interior[i] = interior[i - 1] + 1
    for i in range(len(interior) - 1, -1, -1):  # pushed past n - 1: pull back
        cap_i = n - (len(interior) - i)
        if interior[i] > cap_i:
            interior[i] = cap_i
    return np.concatenate([[0], interior])


def _ranks_per_card(n_parts: int, device) -> int:
    """How many of the ``n_parts`` ranks share one card: the ranks spread over
    the cards there are (NCCL takes one card a rank; gloo ranks beyond the
    card count share them). Off the card the host's memory is shared by all."""
    if device is None or torch.device(device).type != "cuda":
        return n_parts
    return -(-n_parts // max(torch.cuda.device_count(), 1))


def _part_tile_budget(n: int, nnz: int, n_parts: int, tb: int, itemsize: int,
                      min_edges: int | None, budget_bytes: int | None, device) -> int:
    """One part's tile budget. An explicit ``budget_bytes`` is divided by the
    part count, as the JAX package does (:376). Without one, the budget of the
    card that holds the part (the port's ``resolve_tile_budget`` for the whole
    graph: 1 GB when every candidate tile fits in it, else from the card's
    free memory) is divided among the parts that share the card
    (``_ranks_per_card``; on the host all P, the JAX package's division)."""
    if budget_bytes is not None:
        per = budget_bytes // n_parts
    else:
        card = resolve_tile_budget(n, nnz, tb, itemsize, min_edges, 0, False, 4,
                                   torch.device("cpu" if device is None else device))
        per = card // _ranks_per_card(n_parts, device)
    return max(per, tb * tb * itemsize)


def partition_graph(csr: CSR, n_parts: int, interior_tiles: bool = False,
                    bsr_tile: int = BSR_DEFAULT_TILE,
                    bsr_min_edges: int | None = None,
                    bsr_budget_bytes: int | None = None,
                    bsr_dtype: str = BSR_DEFAULT_DTYPE,
                    balance: str = "edges",
                    cluster_sizes: np.ndarray | None = None,
                    cuts: np.ndarray | None = None,
                    device=None) -> PartitionedGraph:
    """Partition an adjacency CSR (self-loops included) into ``n_parts``
    node ranges (cuda_gcn_tpu/parallel/partition.py:230-464, cut selection
    by ``partition_cuts`` unless ``cuts`` are given).

    With ``interior_tiles`` each part's square interior gets the bsr
    treatment of data/graph.py: its densest [tb, tb] blocks become tiles (the
    same selection as the JAX package's ``_select_bsr_tiles``, no pair
    closing) and the interior arrays keep the residual edges. The tile budget
    of a part is ``_part_tile_budget``'s; ``device`` is the card whose free
    memory sizes it when no budget is given."""
    n = csr.nrows
    indptr = csr.indptr.astype(np.int64)
    indices = csr.indices.astype(np.int64)
    coef = normalization_coefficients(indptr, indices)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices

    if cuts is not None:  # caller-chosen cuts (reorder.partition_layout)
        starts = np.asarray(cuts, dtype=np.int64)
        if len(starts) != n_parts or starts[0] != 0 or not (
                np.diff(np.append(starts, n)) > 0).all():
            raise ValueError(f"cuts must be {n_parts} increasing starts from 0 that leave "
                             f"every part >= 1 node, got {starts} for n={n}")
    else:
        starts = partition_cuts(indptr, n_parts, balance, cluster_sizes)
    bounds = np.append(starts, n)
    block = int((bounds[1:] - bounds[:-1]).max())

    # halo needs in one owner-sort pass: each part's edges are one slice of
    # the CSR, and one unique over (owner, dst) gives every peer's list
    d_owner = np.searchsorted(starts, dst, side="right") - 1
    band_st = np.searchsorted(src, starts)
    band_en = np.append(band_st[1:], len(src))
    needed: dict[tuple[int, int], np.ndarray] = {}
    for p in range(n_parts):
        sl = slice(int(band_st[p]), int(band_en[p]))
        do_p, d_p = d_owner[sl], dst[sl]
        mask = do_p != p
        if mask.any():
            enc = np.unique(do_p[mask] * np.int64(n + 1) + d_p[mask])
            owners = enc // (n + 1)
            dsts = enc % (n + 1)
            st = np.searchsorted(owners, np.arange(n_parts + 1))
            for q in range(n_parts):
                if st[q + 1] > st[q]:
                    needed[(p, q)] = dsts[st[q]:st[q + 1]]

    # halo sections by ring offset: in round k part q ships rows to (q + k) % P
    hmax_k = tuple(
        max(max((len(needed.get((p, (p - k) % n_parts), ()))
                 for p in range(n_parts)), default=0), 1)
        for k in range(1, n_parts))
    off_start = np.concatenate([[0], np.cumsum(hmax_k, dtype=np.int64)])
    halo_space = max(int(off_start[-1]), 1)
    send_secs = []
    for k in range(1, n_parts):
        sec = np.zeros((n_parts, hmax_k[k - 1]), dtype=np.int32)
        for q in range(n_parts):
            ids = needed.get(((q + k) % n_parts, q))  # q sends to q + k
            if ids is not None:
                sec[q, : len(ids)] = (ids - starts[q]).astype(np.int32)
        send_secs.append(sec)

    # per-part local edge lists with halo-remapped destinations, split into
    # interior (destination in the own block) and boundary (in the halo)
    counts = band_en - band_st
    int_counts = np.zeros(n_parts, dtype=np.int64)
    bnd_counts = np.zeros(n_parts, dtype=np.int64)
    per_part = []
    for p in range(n_parts):
        sl = slice(int(band_st[p]), int(band_en[p]))
        s = (src[sl] - starts[p]).astype(np.int32)
        d_glob = dst[sl]
        d_own = d_owner[sl]
        # own rows directly; a halo row at its place in its sender's section
        d_loc = np.empty(len(d_glob), dtype=np.int32)
        own = d_own == p
        d_loc[own] = (d_glob[own] - starts[p]).astype(np.int32)
        for q in np.unique(d_own[~own]):
            m = d_own == q
            k_off = (p - q) % n_parts
            pos = np.searchsorted(needed[(p, q)], d_glob[m])
            d_loc[m] = (block + off_start[k_off - 1] + pos).astype(np.int32)
        per_part.append((s, d_loc, coef[sl].astype(np.float32), own))
        int_counts[p] = int(own.sum())
        bnd_counts[p] = int(counts[p]) - int_counts[p]

    tile_kwargs: dict = {}
    interior_resid = None
    if interior_tiles:
        itemsize = torch.empty(0, dtype=_TORCH_DTYPES[bsr_dtype]).element_size()
        per_budget = _part_tile_budget(n, len(src), n_parts, bsr_tile, itemsize,
                                       bsr_min_edges, bsr_budget_bytes, device)
        tiles_pp, interior_resid = [], []
        i_nblocks = -(-block // bsr_tile)
        for p in range(n_parts):
            s, d, c, interior = per_part[p]
            si, di, ci = s[interior].astype(np.int64), d[interior].astype(np.int64), c[interior]
            ekey = np.sort(si * np.int64(block) + di)
            uniq = not bool(np.any(ekey[1:] == ekey[:-1]))
            candidates, tile_id, _ = _select_tile_ids(si, di, block, bsr_tile, bsr_min_edges,
                                                      per_budget, itemsize)
            kk = len(candidates)
            rank_of = np.full(i_nblocks * i_nblocks, -1, dtype=np.int64)
            rank_of[candidates] = np.arange(kk)
            edge_rank = rank_of[tile_id]
            in_tile = edge_rank >= 0
            flat = (edge_rank[in_tile] * bsr_tile * bsr_tile
                    + (si[in_tile] % bsr_tile) * bsr_tile + di[in_tile] % bsr_tile)
            tiles_pp.append((flat, ci[in_tile], (candidates // i_nblocks).astype(np.int32),
                             (candidates % i_nblocks).astype(np.int32), uniq))
            keep = ~in_tile
            interior_resid.append((si[keep].astype(np.int32), di[keep].astype(np.int32),
                                   ci[keep]))
            int_counts[p] = len(interior_resid[-1][0])
        kmax = max(max(len(t[2]) for t in tiles_pp), 1)
        # padding tile rows take the last block id, so that rows stay sorted
        i_tile_rows = np.full((n_parts, kmax), i_nblocks - 1, dtype=np.int32)
        i_tile_cols = np.zeros((n_parts, kmax), dtype=np.int32)
        for p, (_, _, trows, tcols, _) in enumerate(tiles_pp):
            i_tile_rows[p, :len(trows)] = trows
            i_tile_cols[p, :len(tcols)] = tcols
        tile_kwargs = dict(
            i_tile_rows=i_tile_rows, i_tile_cols=i_tile_cols,
            i_tile_counts=np.array([len(t[2]) for t in tiles_pp], dtype=np.int64),
            i_tile_flat=[t[0] for t in tiles_pp], i_tile_vals=[t[1] for t in tiles_pp],
            i_tile_unique=[t[4] for t in tiles_pp], tb=bsr_tile, i_nblocks=i_nblocks,
            tile_dtype=bsr_dtype)

    eimax = max(int(int_counts.max()), 1)
    ebmax = max(int(bnd_counts.max()), 1)
    i_src = np.full((n_parts, eimax), block - 1, dtype=np.int32)
    i_dst = np.zeros((n_parts, eimax), dtype=np.int32)
    i_coef = np.zeros((n_parts, eimax), dtype=np.float32)
    it_src = np.full((n_parts, eimax), block - 1, dtype=np.int32)
    it_dst = np.zeros((n_parts, eimax), dtype=np.int32)
    it_coef = np.zeros((n_parts, eimax), dtype=np.float32)
    b_src = np.full((n_parts, ebmax), block - 1, dtype=np.int32)
    b_dst = np.zeros((n_parts, ebmax), dtype=np.int32)
    b_coef = np.zeros((n_parts, ebmax), dtype=np.float32)
    bt_src = np.full((n_parts, ebmax), halo_space - 1, dtype=np.int32)
    bt_dst = np.zeros((n_parts, ebmax), dtype=np.int32)
    bt_coef = np.zeros((n_parts, ebmax), dtype=np.float32)
    for p in range(n_parts):
        s, d, c, interior = per_part[p]
        if interior_resid is not None:
            si, di, ci = interior_resid[p]
        else:
            si, di, ci = s[interior], d[interior], c[interior]
        ki = len(si)
        i_src[p, :ki], i_dst[p, :ki], i_coef[p, :ki] = si, di, ci
        perm = np.argsort(di, kind="stable")
        it_src[p, :ki], it_dst[p, :ki], it_coef[p, :ki] = di[perm], si[perm], ci[perm]
        sb, db, cb = s[~interior], d[~interior] - block, c[~interior]
        kb = len(sb)
        b_src[p, :kb], b_dst[p, :kb], b_coef[p, :kb] = sb, db, cb
        perm = np.argsort(db, kind="stable")
        bt_src[p, :kb], bt_dst[p, :kb], bt_coef[p, :kb] = db[perm], sb[perm], cb[perm]

    return PartitionedGraph(
        n_parts=n_parts, block=block, n_nodes=n, starts=starts,
        hmax_k=hmax_k, off_start=off_start.astype(np.int64), halo_space=halo_space,
        send_secs=send_secs,
        i_src=i_src, i_dst=i_dst, i_coef=i_coef,
        it_src=it_src, it_dst=it_dst, it_coef=it_coef,
        b_src=b_src, b_dst=b_dst, b_coef=b_coef,
        bt_src=bt_src, bt_dst=bt_dst, bt_coef=bt_coef,
        eimax=eimax, ebmax=ebmax, i_counts=int_counts, b_counts=bnd_counts,
        **tile_kwargs)
