"""Synthetic datasets: the port's copy of cuda_gcn_tpu/data/synthetic.py:24-230.

``PROFILES``, ``SynthSpec``, ``VARIANTS``, ``spec_for``, ``_sample_edges``,
``make_synthetic`` and ``write_dataset`` as in the JAX package, which the port
cannot import (its ``data/__init__.py`` pulls in jax). The same name or spec and
seed give the same arrays, drawn from one ``numpy.random.default_rng(seed)``
stream: a homophilous power-law graph with the parser's prepended self-loops,
class-correlated sparse features, a split and label noise. ``make_synthetic``
returns the port's ``GCNDataset``; ``write_dataset`` writes the reference's
three text files, which data/parser.py reads back.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cuda_gcn_torch.data.dataset import CSR, GCNDataset

# name -> (nodes, undirected_edges, classes, features) of the reference datasets
PROFILES = {
    "synth-cora": (2708, 5429, 7, 1433),
    "synth-citeseer": (3327, 4732, 6, 3703),
    "synth-pubmed": (19717, 44338, 3, 500),
    "synth-reddit": (232965, 11606919, 41, 602),
    # reddit scaled up 4x to 32x, with the same class and feature dims
    "synth-reddit4x": (931860, 46427676, 41, 602),
    "synth-reddit8x": (1863720, 92855352, 41, 602),
    "synth-reddit16x": (3727440, 185710704, 41, 602),
    "synth-reddit32x": (7454880, 371421408, 41, 602),
}


@dataclasses.dataclass
class SynthSpec:
    num_nodes: int
    num_edges: int          # undirected edge count (each appears twice in .graph)
    num_classes: int
    input_dim: int
    homophily: float = 0.8  # probability an edge endpoint shares the source's class
    nnz_per_node: int = 20  # sparse features per node
    train_per_class: int = 20
    num_val: int = 500
    num_test: int = 1000
    powerlaw: float = 0.8   # degree skew (0 = uniform)
    # difficulty knobs: all three leave the sampled graph bit-identical (the
    # RNG stream consumes the same draws; label noise draws after the split),
    # so cached locality permutations stay valid
    feat_band_p: float = 0.7   # P(feature id drawn from the class band)
    feat_noise: float = 0.1    # feature value noise sigma
    label_noise: float = 0.0   # fraction of labels flipped to a random class


# Named variants: (base profile, spec overrides). 'slope' weakens the feature
# signal and lowers the label noise of synth-reddit, so that its converged
# accuracy sits below the attainable ceiling.
VARIANTS = {
    "synth-reddit-slope": ("synth-reddit", dict(
        label_noise=0.05, feat_band_p=0.28, feat_noise=1.3)),
}


def spec_for(name: str, **overrides) -> SynthSpec:
    if name in VARIANTS:
        base, var = VARIANTS[name]
        return spec_for(base, **{**var, **overrides})
    n, e, c, f = PROFILES[name]
    spec = SynthSpec(num_nodes=n, num_edges=e, num_classes=c, input_dim=f)
    # scale the split sizes for big graphs (reddit-style: most nodes labeled)
    if n > 100_000:
        spec.train_per_class = max(20, n // (4 * c))
        spec.num_val = n // 10
        spec.num_test = n // 5
    # named profiles: weak class-band features, value noise and label noise,
    # stronger on the big profiles; the adjacency sample is unchanged by them
    spec.feat_band_p = 0.45
    spec.feat_noise = 0.6
    spec.label_noise = 0.1 if n <= 100_000 else 0.15
    return dataclasses.replace(spec, **overrides)


def _sample_edges(rng: np.random.Generator, spec: SynthSpec, labels: np.ndarray):
    """Vectorized homophilous edge sampling with power-law source propensity."""
    n, e = spec.num_nodes, spec.num_edges
    # degree propensity ~ (rank)^-powerlaw
    prop = (np.arange(1, n + 1, dtype=np.float64)) ** (-spec.powerlaw)
    rng.shuffle(prop)
    prop /= prop.sum()
    src = rng.choice(n, size=e, p=prop)
    dst = rng.integers(0, n, size=e)
    # rewire a homophily fraction to same-class targets
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
    # drop self edges, symmetrize, dedupe
    keep = src != dst
    src, dst = src[keep], dst[keep]
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    key = a * n + b
    _, uniq = np.unique(key, return_index=True)
    return a[uniq], b[uniq]


def make_synthetic(name_or_spec, seed: int = 0) -> GCNDataset:
    spec = spec_for(name_or_spec) if isinstance(name_or_spec, str) else name_or_spec
    rng = np.random.default_rng(seed)
    n, c, f = spec.num_nodes, spec.num_classes, spec.input_dim

    labels = rng.integers(0, c, size=n).astype(np.int32)

    src, dst = _sample_edges(rng, spec, labels)
    # adjacency CSR with the parser's prepended self-loops
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
    graph = CSR(indptr=indptr.astype(np.int32), indices=indices.astype(np.int32))

    # class-correlated sparse features: each class owns a band of feature ids;
    # a node draws most of its nnz from its class band, the rest anywhere.
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
    # dedupe per row by keeping first occurrence (svmlight wants unique keys)
    sort_ix = np.argsort(feat_ids, axis=1, kind="stable")
    feat_ids = np.take_along_axis(feat_ids, sort_ix, axis=1)
    feat_vals = np.take_along_axis(feat_vals, sort_ix, axis=1)
    dup = np.zeros((n, k), dtype=bool)
    dup[:, 1:] = feat_ids[:, 1:] == feat_ids[:, :-1]
    keep = ~dup
    row_counts = keep.sum(axis=1)
    f_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_counts, out=f_indptr[1:])
    feature_index = CSR(
        indptr=f_indptr.astype(np.int32),
        indices=feat_ids[keep].astype(np.int32),
    )
    feature_value = feat_vals[keep]

    # split: per-class train nodes, then val, then test (cora-style conventions)
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

    # label noise LAST (extra draws after the split: the graph/features/split
    # sampled above are unchanged for a given seed regardless of this knob).
    # Flips hit train supervision and eval targets alike, capping attainable
    # accuracy at ~1 - noise*(1 - 1/c) like real-world annotation noise.
    if spec.label_noise > 0:
        flip = rng.random(n) < spec.label_noise
        labels = np.where(
            flip, rng.integers(0, c, size=n).astype(np.int32), labels)

    return GCNDataset(
        graph=graph,
        feature_index=feature_index,
        feature_value=feature_value,
        label=labels,
        split=split,
        num_nodes=n,
        input_dim=f,
        output_dim=c,
    )


def write_dataset(ds: GCNDataset, data_dir: str, name: str) -> None:
    """Write a dataset in the reference 3-file text format (self-loops stripped:
    the parser re-adds them, parser.cpp:30-33)."""
    import os

    os.makedirs(data_dir, exist_ok=True)
    with open(os.path.join(data_dir, f"{name}.graph"), "w") as fh:
        for i in range(ds.num_nodes):
            lo, hi = ds.graph.indptr[i], ds.graph.indptr[i + 1]
            neigh = [str(j) for j in ds.graph.indices[lo:hi] if j != i]
            fh.write(" ".join(neigh) + "\n")
    with open(os.path.join(data_dir, f"{name}.split"), "w") as fh:
        fh.write("\n".join(str(int(s)) for s in ds.split) + "\n")
    with open(os.path.join(data_dir, f"{name}.svmlight"), "w") as fh:
        for i in range(ds.num_nodes):
            lo, hi = ds.feature_index.indptr[i], ds.feature_index.indptr[i + 1]
            kvs = " ".join(
                f"{int(k)}:{float(v):.6g}"
                for k, v in zip(ds.feature_index.indices[lo:hi], ds.feature_value[lo:hi])
            )
            fh.write(f"{int(ds.label[i])} {kvs}".rstrip() + "\n")
