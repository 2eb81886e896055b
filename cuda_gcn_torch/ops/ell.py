"""Bucketed-ELL SpMM for the ``ell`` and ``pallas`` backends — kernel 3
(csrc/ell_spmm.cu).

out[rows_b[r]] = Σ_{k<W_b} coef_b[r, k] · h[cols_b[r, k]] for every bucket b of
the ELL packing (data/graph.py ``build_ell``). This replaces the TPU kernel
``_ell_kernel`` (cuda_gcn_tpu/ops/pallas_spmm.py:67, launched per bucket by
``ell_spmm`` :121) and the XLA path ``graphsum._ell_apply``/
``_ell_bucket_apply`` (cuda_gcn_tpu/ops/graphsum.py:47-72). Every node sits in
exactly one bucket, so every output row is written once.

The VMEM test ``fits_vmem`` and the ``pallas`` → XLA ``ell`` fallback of the
JAX package (cuda_gcn_tpu/ops/graphsum.py:312-319) are TPU memory rules and are
not carried over: the card reads h from device memory and L2, so on a CUDA
tensor both backends launch kernel 3 at any graph size.

``EllPlan`` is built once with the graph (the counterpart of ops/bsr.py
``TilePlan``): the buckets' index and value blocks flattened into one slot
array, and a work list that lets one launch cover every bucket of a pass. A
work item is one ELL row, or a chunk of at most ``ELL_CHUNK_SLOTS`` slots of a
wider row; the chunks of a wide row write partial sums that a second kernel of
the same launch adds in chunk order. Items list only a row's real slots: the
pad slots (col 0, coef 0) add nothing to a finite result and are skipped.

A tensor on the CPU takes the plain PyTorch version below; a CUDA tensor
launches the kernel (cuda_gcn_torch.kernels) or raises.

``EdgeMap`` (``edge_map``) is what the GAT's attention kernels
(ops/attention.py) read beside the plans: for every slot of the plan of Âᵀ
(Â's own plan where Â is symmetric) the slot of the same edge in Â's plan,
so that the backward's transpose aggregation gathers its weights and
recomputes its dropout mask by slot instead of scattering with float
atomics; and the output row of every partial sum of both plans. A GCN builds
none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_gcn_torch import kernels

# Slots per work item: rows wider than this are cut into chunks whose partial
# sums are reduced in order (synth-reddit has a row of 43,403 edges).
ELL_CHUNK_SLOTS = 256
# Plain version: gathered elements per row block, about 256 MB in f32.
_PLAIN_BLOCK_ELEMS = 1 << 26


@dataclasses.dataclass
class EllBucket:
    """One degree bucket of the ELL packing (host-side, numpy), as in
    cuda_gcn_tpu/data/graph.py ``EllBucket``."""

    rows: np.ndarray   # (R,) int32 node ids whose rows live in this bucket
    cols: np.ndarray   # (R, W) int32 neighbor ids, padded with 0
    coef: np.ndarray   # (R, W) float32 edge coefficients, padded with 0.0
    width: int


@dataclasses.dataclass
class EllPlan:
    """The ELL packing of one direction of Â on the device."""

    n_nodes: int
    nnz: int                  # real (unpadded) slots
    cols: torch.Tensor        # (S,) int32: each bucket's [R_b, W_b] block, row-major
    coef: torch.Tensor        # (S,) float32 (bfloat16 for bf16 activations), same layout
    rows: torch.Tensor        # (n,) int32: node of each ELL row, buckets in order
    offsets: tuple[int, ...]     # first slot of each bucket, then S
    row_starts: tuple[int, ...]  # first ELL row of each bucket, then n
    widths: tuple[int, ...]      # W_b
    work_beg: torch.Tensor    # (items,) int32 first slot of the item
    work_len: torch.Tensor    # (items,) int32 real slots of the item
    work_dst: torch.Tensor    # (items,) int32 output row, or -(partial + 1)
    split_rows: torch.Tensor  # (n_split,) int32 output row of each chunked row
    split_ptr: torch.Tensor   # (n_split+1,) int32 its partials, in chunk order
    n_partials: int
    # host side, kept so that the items can be listed in another order
    # (``with_order``): first slot and real slots of every ELL row
    row_start: np.ndarray | None = None
    row_len: np.ndarray | None = None
    order: str = "longest"    # the order of the work items (``ORDERS``)

    @property
    def slots(self) -> int:
        return int(self.cols.shape[0])

    def bucket(self, b: int):
        """Device views (rows [R], cols [R, W], coef [R, W]) of bucket b."""
        r0, r1 = self.row_starts[b], self.row_starts[b + 1]
        s0, s1 = self.offsets[b], self.offsets[b + 1]
        w = self.widths[b]
        return (self.rows[r0:r1], self.cols[s0:s1].view(r1 - r0, w),
                self.coef[s0:s1].view(r1 - r0, w))

    def host_buckets(self) -> list[EllBucket]:
        """The buckets as host numpy arrays, in the layout of the JAX build."""
        out = []
        for b, w in enumerate(self.widths):
            rows, cols, coef = self.bucket(b)
            out.append(EllBucket(rows=rows.cpu().numpy(), cols=cols.cpu().numpy(),
                                 coef=coef.float().cpu().numpy(), width=w))
        return out


@dataclasses.dataclass
class WorkList:
    """Work items over rows of slots, on the device, for kernels 2 and 3: each
    item is a row's slots, or a chunk of at most ``ELL_CHUNK_SLOTS`` of a longer
    row whose partial sums are added in chunk order. Whatever the order of the
    items, those of rows without slots are the last ``len(beg) - n_nonempty``."""

    beg: torch.Tensor         # (items,) int32 first slot of the item
    len: torch.Tensor         # (items,) int32 slots of the item
    dst: torch.Tensor         # (items,) int32 output row, or -(partial + 1)
    split_rows: torch.Tensor  # (n_split,) int32 output row of each chunked row
    split_ptr: torch.Tensor   # (n_split+1,) int32 its partials, in chunk order
    n_partials: int
    n_nonempty: int           # items that have slots (the first ones)


def _dev(a, device, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


# Orders in which the items of a work list are launched (``work_list``).
ORDERS = ("longest", "blocks")
# Output rows per block of the 'blocks' order (1024 to 8192 measure alike).
ORDER_BLOCK_ROWS = 4096
# ``pick_order``: the share of edges within a block's width of the diagonal from
# which a graph counts as local. synth-reddit has 0.05 as it is loaded and 0.70
# under its locality permutation.
ORDER_LOCAL_SHARE = 0.5


def _item_order(order: str, item_len: np.ndarray, item_row: np.ndarray) -> np.ndarray:
    """The permutation of the items for ``order``; in every order the items
    without slots come last."""
    if order == "longest":    # the widest rows do not form the tail
        key = -item_len
    elif order == "blocks":   # neighbouring output rows together, longest first within
        key = (item_row // ORDER_BLOCK_ROWS) * (ELL_CHUNK_SLOTS + 1) - item_len
    else:
        raise ValueError(f"unknown item order {order!r}; one of {ORDERS}")
    perm = np.argsort(key, kind="stable")
    return perm[np.argsort(item_len[perm] == 0, kind="stable")]


def pick_order(indptr: np.ndarray, indices: np.ndarray) -> str:
    """The item order for kernel 3 over the rows of this CSR, from what the
    graph shows. Where neighbouring rows gather neighbouring rows of h (a graph
    relabelled for locality, or numbered that way by its source), 'blocks' lets
    the items that run together share them in L1 and L2: on the H100 27% faster
    at d = 82 on the relabelled synth-reddit, and 25% slower than 'longest' on
    the same graph as it is loaded, where there is nothing to share and the
    blocks only unbalance the tail. So: 'blocks' where at least
    ``ORDER_LOCAL_SHARE`` of the edges lie within ``ORDER_BLOCK_ROWS`` of the
    diagonal, else 'longest'."""
    indptr = np.asarray(indptr, np.int64)
    if len(indices) == 0:
        return "longest"
    row = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    near = np.abs(np.asarray(indices, np.int64) - row) < ORDER_BLOCK_ROWS
    return "blocks" if near.mean() >= ORDER_LOCAL_SHARE else "longest"


def work_list(start: np.ndarray, length: np.ndarray, rows: np.ndarray,
              device: torch.device, order: str = "longest") -> WorkList:
    """The work list of rows p whose slots are [start[p], start[p] + length[p])
    and whose sums go to output row rows[p]. A row of no slots still gets one
    item, which writes zeros: every output row listed has exactly one writer.
    ``order`` (one of ``ORDERS``) is the order in which the items are launched:
    'longest' first, or 'blocks' (blocks of ``ORDER_BLOCK_ROWS`` neighbouring
    output rows, longest first within a block); it changes no sum."""
    start, length, rows = (np.asarray(a, np.int64) for a in (start, length, rows))
    n = len(rows)
    # work items: one per row, or one per chunk of a row longer than the chunk
    chunks = np.maximum(1, -(-length // ELL_CHUNK_SLOTS))
    item_p = np.repeat(np.arange(n, dtype=np.int64), chunks)
    within = np.arange(len(item_p), dtype=np.int64) - np.repeat(np.cumsum(chunks) - chunks,
                                                                chunks)
    beg = start[item_p] + within * ELL_CHUNK_SLOTS
    item_len = np.minimum(ELL_CHUNK_SLOTS, length[item_p] - within * ELL_CHUNK_SLOTS)
    split = chunks > 1
    split_item = split[item_p]
    partial = np.cumsum(split_item) - 1  # a split row's chunks are contiguous, in order
    dst = np.where(split_item, -(partial + 1), rows[item_p])
    perm = _item_order(order, item_len, rows[item_p])
    split_ptr = np.zeros(int(split.sum()) + 1, np.int64)
    np.cumsum(chunks[split], out=split_ptr[1:])
    return WorkList(beg=_dev(beg[perm], device), len=_dev(item_len[perm], device),
                    dst=_dev(dst[perm], device), split_rows=_dev(rows[split], device),
                    split_ptr=_dev(split_ptr, device), n_partials=int(split_ptr[-1]),
                    n_nonempty=int(np.count_nonzero(item_len)))


def csr_work_list(row_ptr: np.ndarray, device: torch.device) -> WorkList:
    """The work list over the rows of a CSR whose row pointer is ``row_ptr``."""
    row_ptr = np.asarray(row_ptr, np.int64)
    return work_list(row_ptr[:-1], np.diff(row_ptr), np.arange(len(row_ptr) - 1), device)


def _work_fields(work: WorkList) -> dict:
    return dict(work_beg=work.beg, work_len=work.len, work_dst=work.dst,
                split_rows=work.split_rows, split_ptr=work.split_ptr,
                n_partials=work.n_partials)


def with_order(plan: EllPlan, order: str) -> EllPlan:
    """``plan`` with its work items listed in ``order`` (``work_list``): the
    same slots and the same sums, launched in another order."""
    work = work_list(plan.row_start, plan.row_len, plan.rows.cpu().numpy(), plan.rows.device,
                     order)
    return dataclasses.replace(plan, order=order, **_work_fields(work))


def ell_plan(buckets: list[EllBucket], degrees: np.ndarray, device: torch.device,
             order: str = "longest", coef_dtype: torch.dtype = torch.float32) -> EllPlan:
    """Flatten ``buckets`` onto ``device`` and build the work list, its items
    in ``order``. ``degrees[i]`` is the number of real slots of node i's row;
    the coefficients are stored as ``coef_dtype``."""
    n = len(degrees)
    widths = tuple(int(b.width) for b in buckets)
    counts = [len(b.rows) for b in buckets]
    row_starts = (0, *np.cumsum(counts).tolist())
    offsets = (0, *np.cumsum([c * w for c, w in zip(counts, widths)]).tolist())
    if offsets[-1] >= 2**31:
        raise ValueError(f"{offsets[-1]} ELL slots exceed int32 slot offsets")
    if row_starts[-1] != n:
        raise ValueError(f"the buckets hold {row_starts[-1]} rows, expected {n}")

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts else np.zeros(0, dtype)

    rows = cat([b.rows for b in buckets], np.int64)
    cols = cat([b.cols.reshape(-1) for b in buckets], np.int32)
    coef = cat([b.coef.reshape(-1) for b in buckets], np.float32)

    # slot start and real length of every ELL row p (buckets in order)
    width_p = np.repeat(np.asarray(widths, np.int64), counts)
    start_p = (np.repeat(np.asarray(offsets[:-1], np.int64), counts)
               + (np.arange(n, dtype=np.int64)
                  - np.repeat(np.asarray(row_starts[:-1], np.int64), counts)) * width_p)
    deg_p = np.asarray(degrees, np.int64)[rows]
    work = work_list(start_p, deg_p, rows, device, order)
    return EllPlan(
        n_nodes=n, nnz=int(deg_p.sum()), cols=_dev(cols, device),
        coef=_dev(coef, device, torch.float32).to(coef_dtype), rows=_dev(rows, device), offsets=offsets,
        row_starts=row_starts, widths=widths, row_start=start_p, row_len=deg_p, order=order,
        **_work_fields(work))


def ell_spmm_plain(plan: EllPlan, h: torch.Tensor) -> torch.Tensor:
    """Plain version: per bucket, gather h[cols] [R, W, d], scale by coef and
    sum over the W slots in f32 (row blocks bound the transient), written to
    out[rows]; one cast to h's type at the end."""
    d, dtype = h.shape[1], h.dtype
    h = h.float()
    out = torch.zeros(plan.n_nodes, d, dtype=torch.float32, device=h.device)
    for b, w in enumerate(plan.widths):
        rows, cols, coef = plan.bucket(b)
        step = max(1, _PLAIN_BLOCK_ELEMS // max(w * d, 1))
        for a in range(0, rows.shape[0], step):
            g = h[cols[a:a + step].long()]
            out[rows[a:a + step].long()] = (g * coef[a:a + step, :, None].float()).sum(1)
    return out.to(dtype)


def ell_spmm(plan: EllPlan, h: torch.Tensor) -> torch.Tensor:
    """Â·h over the ELL plan, [n, d] in h's type, summed in f32."""
    if h.device.type == "cpu":
        return ell_spmm_plain(plan, h)
    return kernels.ell_spmm(plan.work_beg, plan.work_len, plan.work_dst,
                            plan.split_rows, plan.split_ptr, plan.cols, plan.coef, h,
                            plan.n_nodes, plan.n_partials)


def slot_edges(plan: EllPlan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot, row, col) of every real slot of ``plan``, int64 on its device,
    rows in the plan's order and each row's slots in order."""
    device = plan.cols.device
    length = torch.from_numpy(np.asarray(plan.row_len, np.int64)).to(device)
    start = torch.from_numpy(np.asarray(plan.row_start, np.int64)).to(device)
    nnz = int(plan.nnz)
    first = torch.cumsum(length, 0) - length
    within = torch.arange(nnz, device=device) - torch.repeat_interleave(first, length,
                                                                         output_size=nnz)
    slot = torch.repeat_interleave(start, length, output_size=nnz) + within
    row = torch.repeat_interleave(plan.rows.long(), length, output_size=nnz)
    return slot, row, plan.cols[slot].long()


def reverse_slots(plan: EllPlan, plan_t: EllPlan) -> torch.Tensor:
    """(plan_t.slots,) int32: for each real slot of ``plan_t`` (row j, column i)
    the slot of the edge (row i, column j) in ``plan``; -1 at a pad slot.
    ``plan_t`` is the plan of the transpose of ``plan``'s matrix (``plan``
    itself for a symmetric one, where the map is an involution). Repeated
    edges are paired in slot order. Raises where ``plan_t`` is not the
    transpose."""
    n = plan.n_nodes
    s_f, r_f, c_f = slot_edges(plan)
    s_t, r_t, c_t = slot_edges(plan_t)
    key_f, order_f = torch.sort(r_f * n + c_f, stable=True)
    key_t, order_t = torch.sort(c_t * n + r_t, stable=True)
    if key_f.shape != key_t.shape or not torch.equal(key_f, key_t):
        raise ValueError("the second plan is not the transpose of the first")
    rev = torch.full((plan_t.slots,), -1, dtype=torch.int32, device=plan_t.cols.device)
    rev[s_t[order_t]] = s_f[order_f].to(torch.int32)
    return rev


def partial_rows(plan: EllPlan) -> torch.Tensor:
    """(n_partials,) int32: the output row of each partial sum of ``plan``'s
    work list (the row of each chunk of a split row)."""
    counts = (plan.split_ptr[1:] - plan.split_ptr[:-1]).long()
    return torch.repeat_interleave(plan.split_rows, counts,
                                   output_size=plan.n_partials).to(torch.int32)


@dataclasses.dataclass
class EdgeMap:
    """The attention kernels' view of a graph's ELL plans (``edge_map``)."""

    plan: EllPlan             # Â's: row i gathers the rows j of its slots
    plan_t: EllPlan           # Âᵀ's, or ``plan`` where Â is symmetric
    rev: torch.Tensor         # (plan_t.slots,) int32: ``reverse_slots(plan, plan_t)``
    partial_rows: torch.Tensor    # (plan.n_partials,) int32
    partial_rows_t: torch.Tensor  # (plan_t.n_partials,) int32
    _edges: tuple | None = None

    def edges(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``slot_edges(plan)``, made at first use and kept: the edge list of
        the attention's plain version."""
        if self._edges is None:
            self._edges = slot_edges(self.plan)
        return self._edges


def edge_map(plan: EllPlan, plan_t: EllPlan | None = None) -> EdgeMap:
    """The ``EdgeMap`` of ``plan`` and the plan of its transpose (None: Â is
    symmetric and ``plan`` is its own)."""
    plan_t = plan if plan_t is None else plan_t
    return EdgeMap(plan=plan, plan_t=plan_t, rev=reverse_slots(plan, plan_t),
                   partial_rows=partial_rows(plan),
                   partial_rows_t=partial_rows(plan) if plan_t is plan else partial_rows(plan_t))
