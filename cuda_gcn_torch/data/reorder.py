"""Locality reordering: label propagation, the cluster-major permutation and
the P-part layout of the sharded trainer.

A numpy copy of cuda_gcn_tpu/data/reorder.py:34-315, which the port cannot
import. Relabelling nodes so that communities are contiguous puts most edges
of Â into a few dense diagonal [tb, tb] blocks, which the ``bsr`` backend
multiplies as dense tiles (kernel 1). Training metrics are sums over nodes, so
a relabelled dataset trains to the same metrics. ``partition_layout`` (cluster
packing into P parts, then boundary refinement) gives the sharded trainer its
node order and part cuts (parallel/sharded.py ``prepare_sharded``).

``label_propagation`` runs the native multithreaded LPA (data/native.py, the
JAX package's ``csrc/gcn_lpa.cpp``) unless it is given ``prefer_native=False``;
the numpy LPA here is the oracle, and the two give the same labels.
"""

from __future__ import annotations

import hashlib

import numpy as np

from cuda_gcn_torch.data import native
from cuda_gcn_torch.data.dataset import CSR, reorder_dataset

__all__ = ["LPA_VERSION", "cluster_order", "label_propagation", "locality_permutation",
           "lpa_cache_key", "partition_aware_order", "partition_layout", "refine_partition",
           "reorder_dataset"]

# Bumped whenever label_propagation's algorithm changes, so that label caches
# keyed on (version, graph) are not reused across algorithms.
LPA_VERSION = 2


def lpa_cache_key(indptr: np.ndarray, indices: np.ndarray) -> str:
    """Short content hash tying an LPA label cache file to the exact graph
    and LPA_VERSION that produced it."""
    h = hashlib.sha1()
    h.update(np.int64(LPA_VERSION).tobytes())
    h.update(np.ascontiguousarray(indptr).tobytes())
    h.update(np.ascontiguousarray(indices).tobytes())
    return h.hexdigest()[:12]


def label_propagation(indptr: np.ndarray, indices: np.ndarray, rounds: int = 4,
                      seed_labels: np.ndarray | None = None,
                      prefer_native: bool = True,
                      max_top_share: float | None = 0.5) -> np.ndarray:
    """Synchronous LPA: per round, each node takes the modal label among its
    neighbors (ties -> smallest label; isolated nodes keep their label).

    ``prefer_native`` runs the rounds in the native LPA, which raises if it
    cannot be built; False runs the numpy code below (the dispatch of
    cuda_gcn_tpu/data/reorder.py:49-86, less its silent fallback).

    ``max_top_share`` is the collapse guard: rounds run one at a time, and if
    a round's top label holds more than that share of the nodes, the previous
    round's labels are returned; a round that changes nothing ends the loop.
    None disables the guard (fixed-round semantics)."""
    if max_top_share is not None and rounds > 1:
        n = len(indptr) - 1
        labels = seed_labels
        for _ in range(rounds):
            new = label_propagation(indptr, indices, rounds=1, seed_labels=labels,
                                    prefer_native=prefer_native, max_top_share=None)
            top = np.bincount(new.astype(np.int64)).max()
            if top > max_top_share * n and labels is not None:
                return labels
            if labels is not None and np.array_equal(new, labels):
                return labels
            labels = new
        return labels
    if prefer_native:
        return native.label_propagation(indptr, indices, rounds, seed_labels)
    n = len(indptr) - 1
    labels = seed_labels.copy() if seed_labels is not None else np.arange(n, dtype=np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    dst = indices.astype(np.int64)
    for _ in range(rounds):
        lab = labels[dst]
        # one fused-key sort; equal keys are identical (src, label) pairs
        order = np.argsort(src * np.int64(n) + lab)
        s, l = src[order], lab[order]
        if len(s) == 0:
            break
        new_run = np.empty(len(s), dtype=bool)
        new_run[0] = True
        new_run[1:] = (s[1:] != s[:-1]) | (l[1:] != l[:-1])
        run_ids = np.cumsum(new_run) - 1
        counts = np.bincount(run_ids)
        run_src = s[new_run]
        run_lab = l[new_run]
        # per src: highest count wins; ties -> smaller label (lexsort is
        # stable and runs are label-ascending within src)
        pick = np.lexsort((-counts, run_src))
        first = np.empty(len(pick), dtype=bool)
        rs = run_src[pick]
        first[0] = True
        first[1:] = rs[1:] != rs[:-1]
        new_labels = labels.copy()
        new_labels[rs[first]] = run_lab[pick][first]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels


def cluster_order(labels: np.ndarray) -> np.ndarray:
    """Permutation placing nodes cluster-major, clusters by size descending,
    original id order within a cluster. Returns perm[new_id] = old_id."""
    uniq, inv, counts = np.unique(labels, return_inverse=True, return_counts=True)
    cluster_rank = np.empty(len(uniq), dtype=np.int64)
    cluster_rank[np.argsort(-counts, kind="stable")] = np.arange(len(uniq))
    return np.lexsort((np.arange(len(labels)), cluster_rank[inv]))


def locality_permutation(csr: CSR, rounds: int = 4, return_cluster_sizes: bool = False):
    """Cluster-major locality permutation; with ``return_cluster_sizes`` also
    the cluster sizes in the new order (descending)."""
    labels = label_propagation(csr.indptr, csr.indices, rounds=rounds)
    perm = cluster_order(labels)
    if not return_cluster_sizes:
        return perm
    _, counts = np.unique(labels, return_counts=True)
    return perm, counts[np.argsort(-counts, kind="stable")]


def partition_aware_order(labels: np.ndarray, n_parts: int,
                          weights: np.ndarray | None = None):
    """Cluster layout for a P-part partition (cuda_gcn_tpu/data/reorder.py:148-208):
    clusters, size descending, go greedily to the part of least weight, and
    the parts are laid out one after another (clusters size descending within
    a part). Clusters heavier than total/P are first cut into chunks of at
    most total/P by ascending node id. Returns (perm, cuts): perm[new_id] =
    old_id, and cuts the P part-start node ids (partition_graph(cuts=...))."""
    n = len(labels)
    uniq, inv, counts = np.unique(labels, return_counts=True,
                                  return_inverse=True)
    w = (np.ones(n, np.float64) if weights is None
         else weights.astype(np.float64))
    if w.sum() <= 0:  # no weight at all: every greedy bin would tie at 0
        w = np.ones(n, np.float64)
    cw = np.bincount(inv, weights=w, minlength=len(uniq))
    cap = cw.sum() / max(n_parts, 1)
    if n_parts > 1 and len(uniq) and cw.max() > cap:
        node_order = np.lexsort((np.arange(n), inv))  # cluster-major, id ascending
        w_ord = w[node_order]
        inv_ord = inv[node_order]
        cum = np.cumsum(w_ord)
        starts = np.searchsorted(inv_ord, np.arange(len(uniq)))
        sizes = np.diff(np.append(starts, n))
        prev = cum - w_ord - np.repeat(cum[starts] - w_ord[starts], sizes)
        sub = (prev // cap).astype(np.int64)  # 0 for every cluster that fits
        refined = np.empty(n, np.int64)
        refined[node_order] = inv_ord * (int(sub.max()) + 1) + sub
        uniq, inv, counts = np.unique(refined, return_counts=True,
                                      return_inverse=True)
        cw = np.bincount(inv, weights=w, minlength=len(uniq))
    order = np.argsort(-cw, kind="stable")
    loads = np.zeros(n_parts)
    part_of = np.empty(len(uniq), np.int64)
    for c in order:
        p = int(np.argmin(loads))
        part_of[c] = p
        loads[p] += cw[c]
    # cluster rank: (part, weight descending, cluster id) -> contiguous parts
    rank = np.lexsort((np.arange(len(uniq)), -cw, part_of))
    cluster_rank = np.empty(len(uniq), np.int64)
    cluster_rank[rank] = np.arange(len(uniq))
    perm = np.lexsort((np.arange(n), cluster_rank[inv]))
    part_nodes = np.bincount(part_of[inv], minlength=n_parts)
    cuts = np.concatenate([[0], np.cumsum(part_nodes)[:-1]])
    return perm, cuts.astype(np.int64)


def refine_partition(indptr: np.ndarray, indices: np.ndarray,
                     part_of: np.ndarray, n_parts: int, weights: np.ndarray,
                     sweeps: int = 2, slack: float = 1.05) -> np.ndarray:
    """Boundary refinement of a P-part node assignment under a weight-balance
    band (cuda_gcn_tpu/data/reorder.py:211-287): per sweep every node bids for
    the part that holds most of its edges; the better half of the bids by gain
    is admitted, and the lowest-gain movers are taken back until every part's
    load lies in [W/(P·slack), slack·W/P]. Returns the refined assignment, in
    the same node order."""
    n = len(indptr) - 1
    w = weights.astype(np.float64)
    total = w.sum()
    cap_load = slack * total / n_parts
    floor_load = total / (slack * n_parts)
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(indptr.astype(np.int64)))
    dst = indices.astype(np.int64)
    part_of = part_of.astype(np.int32).copy()
    rows = np.arange(n)
    for _ in range(sweeps):
        cnt = np.bincount(src * n_parts + part_of[dst],
                          minlength=n * n_parts).reshape(n, n_parts)
        best = np.argmax(cnt, axis=1).astype(np.int32)
        gain = cnt[rows, best] - cnt[rows, part_of]
        movers = np.flatnonzero((gain > 0) & (best != part_of))
        if not len(movers):
            break
        loads = np.bincount(part_of, weights=w, minlength=n_parts)
        order = movers[np.argsort(-gain[movers], kind="stable")]
        # only the top half by gain: synchronous all-move sweeps swap
        # symmetric regions back and forth
        order = order[: max(1, (len(order) + 1) // 2)]
        wo = w[order]
        src_p, dst_p = part_of[order], best[order]
        admit = np.ones(len(order), bool)
        for _ in range(100):
            la = loads + np.bincount(dst_p[admit], weights=wo[admit],
                                     minlength=n_parts) \
                       - np.bincount(src_p[admit], weights=wo[admit],
                                     minlength=n_parts)
            bad = False
            for p in np.flatnonzero(la > cap_load + 1e-9):
                sel = np.flatnonzero(admit & (dst_p == p))[::-1]
                cut = np.searchsorted(np.cumsum(wo[sel]), la[p] - cap_load)
                admit[sel[:cut + 1]] = False
                bad = True
            for p in np.flatnonzero(la < floor_load - 1e-9):
                sel = np.flatnonzero(admit & (src_p == p))[::-1]
                cut = np.searchsorted(np.cumsum(wo[sel]), floor_load - la[p])
                admit[sel[:cut + 1]] = False
                bad = True
            if not bad:
                break
        else:  # the band could not be restored: no move this sweep
            admit[:] = False
        moved = order[admit]
        if not len(moved):
            break
        part_of[moved] = best[moved]
    return part_of


def partition_layout(indptr: np.ndarray, indices: np.ndarray,
                     labels: np.ndarray, n_parts: int,
                     weights: np.ndarray | None = None,
                     refine_sweeps: int = 2, slack: float = 1.05):
    """``partition_aware_order`` then ``refine_partition``
    (cuda_gcn_tpu/data/reorder.py:290-315); (perm, cuts) as the former gives
    them. Within a part, nodes keep the cluster-major order."""
    perm, cuts = partition_aware_order(labels, n_parts, weights=weights)
    if n_parts <= 1 or refine_sweeps <= 0:
        return perm, cuts
    n = len(labels)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    part_of = (np.searchsorted(cuts, inv, side="right") - 1).astype(np.int32)
    w = (np.ones(n, np.float64) if weights is None
         else weights.astype(np.float64))
    refined = refine_partition(indptr, indices, part_of, n_parts, w,
                               sweeps=refine_sweeps, slack=slack)
    counts = np.bincount(refined, minlength=n_parts)
    if (counts == 0).any():  # a part emptied: keep the packed layout
        return perm, cuts
    perm2 = np.lexsort((inv, refined))
    cuts2 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return perm2, cuts2.astype(np.int64)
