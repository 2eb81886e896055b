"""Locality reordering: label propagation and the cluster-major permutation.

A numpy copy of cuda_gcn_tpu/data/reorder.py:34-145, which the port cannot
import. Relabelling nodes so that communities are contiguous puts most edges
of Â into a few dense diagonal [tb, tb] blocks, which the ``bsr`` backend
multiplies as dense tiles (kernel 1). Training metrics are sums over nodes, so
a relabelled dataset trains to the same metrics.

Only the numpy LPA is copied; the JAX package's native C++ LPA is its own host
library and computes the same labels.
"""

from __future__ import annotations

import hashlib

import numpy as np

from cuda_gcn_torch.data.dataset import CSR, reorder_dataset

__all__ = ["LPA_VERSION", "cluster_order", "label_propagation", "locality_permutation",
           "lpa_cache_key", "reorder_dataset"]

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
                      max_top_share: float | None = 0.5) -> np.ndarray:
    """Synchronous LPA: per round, each node takes the modal label among its
    neighbors (ties -> smallest label; isolated nodes keep their label).

    ``max_top_share`` is the collapse guard: rounds run one at a time, and if
    a round's top label holds more than that share of the nodes, the previous
    round's labels are returned; a round that changes nothing ends the loop.
    None disables the guard (fixed-round semantics)."""
    if max_top_share is not None and rounds > 1:
        n = len(indptr) - 1
        labels = seed_labels
        for _ in range(rounds):
            new = label_propagation(indptr, indices, rounds=1, seed_labels=labels,
                                    max_top_share=None)
            top = np.bincount(new.astype(np.int64)).max()
            if top > max_top_share * n and labels is not None:
                return labels
            if labels is not None and np.array_equal(new, labels):
                return labels
            labels = new
        return labels
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
