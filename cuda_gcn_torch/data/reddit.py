"""Offline converter: GraphSAGE reddit dumps -> .graph/.split/.svmlight.

The port's copy of cuda_gcn_tpu/data/reddit.py (numpy and json only; the port
imports nothing of the JAX package), writing the same files byte for byte.
Functional equivalent of the reference's ``reddit_preprocess.py`` (the offline
Python stage, SURVEY.md §3.5), without networkx or sklearn:

* loads ``<prefix>-G.json`` (node-link graph), ``<prefix>-feats.npy``,
  ``<prefix>-id_map.json``, ``<prefix>-class_map.json``;
* drops nodes lacking val/test annotations (reddit_preprocess.py:53-58);
* standardizes features with mean/std fit on the TRAIN rows only
  (reddit_preprocess.py:71-77; zero-variance columns keep scale 1, like
  sklearn's StandardScaler);
* relabels kept nodes to 0..n-1 in sorted-original-id order
  (reddit_preprocess.py:101-105: ids re-sorted after concatenation);
* writes the three text files (self-loops NOT written — the parser adds them)
  with split codes 1=train / 2=val / 3=test and only nonzero feature entries
  in the svmlight lines, plus an optional fast ``.npz`` copy.

Usage: ``python -m cuda_gcn_torch.data.reddit <dir-with-dumps> [--prefix reddit]``;
the output is read by ``cuda_gcn_torch.cli <prefix> --data-dir <dir>``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_graphsage(prefix: str):
    """Load the 4 GraphSAGE files; returns (nodes, edges, feats, id_map, class_map).

    nodes: dict id -> {'val': bool, 'test': bool}; edges: list[(id, id)].
    Node ids may be ints or strings; link endpoints may be ids or positional
    indices into the node list (both occur in the wild) — handled either way.
    """
    with open(prefix + "-G.json") as f:
        g = json.load(f)
    raw_nodes = g["nodes"]
    node_ids = [n.get("id") for n in raw_nodes]
    id_set = set(node_ids)
    nodes = {
        n["id"]: {"val": n.get("val"), "test": n.get("test")}
        for n in raw_nodes
    }
    edges = []
    links = g.get("links", g.get("edges", []))
    for e in links:
        s, t = e["source"], e["target"]
        if s not in id_set and isinstance(s, int) and 0 <= s < len(node_ids):
            s = node_ids[s]
        if t not in id_set and isinstance(t, int) and 0 <= t < len(node_ids):
            t = node_ids[t]
        edges.append((s, t))

    feats = np.load(prefix + "-feats.npy") if os.path.exists(prefix + "-feats.npy") else None

    with open(prefix + "-id_map.json") as f:
        id_map = json.load(f)
    with open(prefix + "-class_map.json") as f:
        class_map = json.load(f)
    # key types in the json are strings; convert to match node id type
    sample = node_ids[0] if node_ids else ""
    conv = int if isinstance(sample, int) else (lambda x: x)
    id_map = {conv(k): int(v) for k, v in id_map.items()}
    class_map = {conv(k): v for k, v in class_map.items()}
    if class_map and isinstance(next(iter(class_map.values())), list):
        raise NotImplementedError("multilabel class maps are not supported (reddit is single-label)")
    return nodes, edges, feats, id_map, class_map


def convert(src_dir: str, prefix: str = "reddit", out_dir: str | None = None,
            normalize: bool = True, write_npz: bool = True) -> str:
    out_dir = out_dir or src_dir
    nodes, edges, feats, id_map, class_map = load_graphsage(os.path.join(src_dir, prefix))

    # drop nodes without proper val/test annotations
    kept = {nid: a for nid, a in nodes.items() if a["val"] is not None and a["test"] is not None}
    dropped = len(nodes) - len(kept)
    if dropped:
        print(f"Removed {dropped} nodes that lacked proper annotations")

    # relabel to 0..n-1 in sorted-original-id order
    order = sorted(kept.keys())
    new_id = {nid: i for i, nid in enumerate(order)}
    n = len(order)

    # standardize features on train statistics
    if feats is not None and normalize:
        train_rows = np.array([id_map[nid] for nid in order
                               if not kept[nid]["val"] and not kept[nid]["test"]])
        mean = feats[train_rows].mean(axis=0)
        std = feats[train_rows].std(axis=0)
        std = np.where(std == 0, 1.0, std)
        feats = (feats - mean) / std

    # adjacency rows in new-id space (both directions: an undirected edge shows
    # in both endpoint rows, like networkx G.neighbors)
    adj: list[list[int]] = [[] for _ in range(n)]
    for s, t in edges:
        if s in new_id and t in new_id:
            adj[new_id[s]].append(new_id[t])
            adj[new_id[t]].append(new_id[s])

    labels = np.array([int(class_map[nid]) for nid in order], dtype=np.int32)
    split = np.zeros(n, dtype=np.int32)
    for nid in order:
        a = kept[nid]
        split[new_id[nid]] = 1 if not (a["val"] or a["test"]) else (2 if a["val"] else 3)

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{prefix}.graph"), "w") as fh:
        for i in range(n):
            fh.write(" ".join(str(j) for j in adj[i]) + "\n")
    with open(os.path.join(out_dir, f"{prefix}.split"), "w") as fh:
        fh.write("\n".join(str(int(s)) for s in split) + "\n")
    with open(os.path.join(out_dir, f"{prefix}.svmlight"), "w") as fh:
        for i, nid in enumerate(order):
            row = feats[id_map[nid]] if feats is not None else np.empty(0)
            nz = np.flatnonzero(row)
            kvs = " ".join(f"{k}:{row[k]:.6g}" for k in nz)
            fh.write(f"{labels[i]} {kvs}".rstrip() + "\n")

    if write_npz and feats is not None:
        dense = np.stack([feats[id_map[nid]] for nid in order]).astype(np.float32)
        counts = np.fromiter((len(a) for a in adj), dtype=np.int64, count=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        flat = np.fromiter((x for a in adj for x in a), dtype=np.int64, count=int(counts.sum()))
        np.savez(os.path.join(out_dir, f"{prefix}.npz"),
                 adj_indptr=indptr, adj_indices=flat, features=dense,
                 label=labels, split=split)
    return out_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src_dir")
    ap.add_argument("--prefix", default="reddit")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--no-normalize", action="store_true")
    args = ap.parse_args(argv)
    out = convert(args.src_dir, args.prefix, args.out_dir, normalize=not args.no_normalize)
    print(f"wrote {args.prefix}.graph/.split/.svmlight under {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
