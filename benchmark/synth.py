"""The benchmark's frozen copy of the port's synthetic graph generator.

A copy of ``SynthSpec``, ``spec_for``, ``_sample_edges`` and ``make_synthetic``
from ``cuda_gcn_torch/data/synthetic.py`` as they stand when the benchmark was
written, so that a later change to the program's generator cannot change the
benchmark's inputs. ``spec_for`` takes the profile's sizes from the
configuration file instead of the program's ``PROFILES`` table, and
``make_synthetic`` returns plain numpy arrays, since the reference must not
touch the program's types: a homophilous power-law graph with the reference
parser's prepended self-loops, class-correlated sparse features, a split and
label noise, all drawn from one ``numpy.random.default_rng(seed)`` stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SynthSpec:
    num_nodes: int
    num_edges: int          # undirected edge count (each appears twice in the graph)
    num_classes: int
    input_dim: int
    homophily: float = 0.8
    nnz_per_node: int = 20
    train_per_class: int = 20
    num_val: int = 500
    num_test: int = 1000
    powerlaw: float = 0.8
    feat_band_p: float = 0.7
    feat_noise: float = 0.1
    label_noise: float = 0.0


def spec_for(num_nodes: int, num_edges: int, num_classes: int, input_dim: int,
             **overrides) -> SynthSpec:
    """The spec of a named profile of these sizes (synthetic.py ``spec_for``)."""
    n, c = num_nodes, num_classes
    spec = SynthSpec(num_nodes=n, num_edges=num_edges, num_classes=c, input_dim=input_dim)
    if n > 100_000:
        spec.train_per_class = max(20, n // (4 * c))
        spec.num_val = n // 10
        spec.num_test = n // 5
    spec.feat_band_p = 0.45
    spec.feat_noise = 0.6
    spec.label_noise = 0.1 if n <= 100_000 else 0.15
    return dataclasses.replace(spec, **overrides)


def _sample_edges(rng: np.random.Generator, spec: SynthSpec, labels: np.ndarray):
    n, e = spec.num_nodes, spec.num_edges
    prop = (np.arange(1, n + 1, dtype=np.float64)) ** (-spec.powerlaw)
    rng.shuffle(prop)
    prop /= prop.sum()
    src = rng.choice(n, size=e, p=prop)
    dst = rng.integers(0, n, size=e)
    homo = rng.random(e) < spec.homophily
    by_class = [np.flatnonzero(labels == c) for c in range(spec.num_classes)]
    homo_idx = np.flatnonzero(homo)
    src_cls = labels[src[homo_idx]]
    new_dst = np.empty(len(homo_idx), dtype=np.int64)
    for c in range(spec.num_classes):
        sel = src_cls == c
        k = int(sel.sum())
        if k:
            new_dst[sel] = by_class[c][rng.integers(0, len(by_class[c]), size=k)]
    dst[homo_idx] = new_dst
    keep = src != dst
    src, dst = src[keep], dst[keep]
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    _, uniq = np.unique(a * n + b, return_index=True)
    return a[uniq], b[uniq]


def make_synthetic(spec: SynthSpec, seed: int = 0) -> dict[str, np.ndarray | int]:
    """The arrays of one synthetic dataset: ``indptr``/``indices`` (adjacency
    CSR, self-loop first in each row), ``f_indptr``/``f_indices``/``f_values``
    (feature CSR), ``label``, ``split`` (1 train, 2 val, 3 test, 0 none) and
    the sizes ``num_nodes``, ``input_dim``, ``output_dim``."""
    rng = np.random.default_rng(seed)
    n, c, f = spec.num_nodes, spec.num_classes, spec.input_dim
    labels = rng.integers(0, c, size=n).astype(np.int32)

    src, dst = _sample_edges(rng, spec, labels)
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    deg = np.bincount(src_s, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg + 1, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int64)
    indices[indptr[:-1]] = np.arange(n)
    mask = np.ones(indptr[-1], dtype=bool)
    mask[indptr[:-1]] = False
    indices[mask] = dst_s

    k = min(spec.nnz_per_node, f)
    band = max(f // c, 1)
    in_band = rng.random((n, k)) < spec.feat_band_p
    band_lo = (labels.astype(np.int64) * band) % f
    feat_ids = np.where(
        in_band,
        band_lo[:, None] + rng.integers(0, band, size=(n, k)),
        rng.integers(0, f, size=(n, k)),
    ) % f
    feat_vals = (1.0 + spec.feat_noise * rng.standard_normal((n, k))).astype(np.float32)
    sort_ix = np.argsort(feat_ids, axis=1, kind="stable")
    feat_ids = np.take_along_axis(feat_ids, sort_ix, axis=1)
    feat_vals = np.take_along_axis(feat_vals, sort_ix, axis=1)
    dup = np.zeros((n, k), dtype=bool)
    dup[:, 1:] = feat_ids[:, 1:] == feat_ids[:, :-1]
    keep = ~dup
    f_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=f_indptr[1:])

    split = np.zeros(n, dtype=np.int32)
    perm = rng.permutation(n)
    taken = np.zeros(n, dtype=bool)
    for cls in range(c):
        cls_nodes = perm[labels[perm] == cls][: spec.train_per_class]
        split[cls_nodes] = 1
        taken[cls_nodes] = True
    rest = perm[~taken[perm]]
    split[rest[: spec.num_val]] = 2
    split[rest[spec.num_val : spec.num_val + spec.num_test]] = 3

    if spec.label_noise > 0:
        flip = rng.random(n) < spec.label_noise
        labels = np.where(flip, rng.integers(0, c, size=n).astype(np.int32), labels)

    return dict(indptr=indptr.astype(np.int32), indices=indices.astype(np.int32),
                f_indptr=f_indptr.astype(np.int32), f_indices=feat_ids[keep].astype(np.int32),
                f_values=feat_vals[keep], label=labels, split=split,
                num_nodes=n, input_dim=f, output_dim=c)
