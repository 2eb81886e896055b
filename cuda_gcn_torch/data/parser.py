"""Dataset parser for the ``.graph`` / ``.split`` / ``.svmlight`` text format
(cuda_gcn_tpu/data/parser.py:92-187), the reference program's way in:
``./gcn-seq <name>`` reads ``data/<name>.{graph,split,svmlight}``.

Behaviour, matching the reference parser (src/common/parser.cpp):

* ``<name>.graph``: line i holds the whitespace-separated neighbour ids of node
  i. A self-loop is put first in every row while the CSR is built
  (parser.cpp:30-33), and ``num_nodes`` is the number of lines (parser.cpp:45).
* ``<name>.svmlight``: one node per line, ``label k:v k:v ...``. Gives the CSR
  feature index, the value array and a label per node; a line whose label does
  not parse gets label -1 and no features (parser.cpp:68-71). ``input_dim`` is
  the largest feature index plus 1 and ``output_dim`` the largest label plus 1
  (parser.cpp:90-91); the reference starts both maxima at 0, so an empty file
  still reports dims of 1.
* ``<name>.split``: one integer per node, 1 = train, 2 = validation, 3 = test,
  anything else unused (parser.cpp:94-103).

The reference drops a last line that has no newline after it; like the JAX
package this parser takes it. ``load_dataset`` parses with the native C++
parser (data/native.py, the JAX package's ``csrc/gcn_parser.cpp``) unless it
is given ``use_native=False``; the numpy parser here is the oracle. The two
give the same arrays, but for feature values, which ``strtof`` reads straight
to f32 where numpy reads them through ``float``: they may differ in the last
bit.
"""

from __future__ import annotations

import os

import numpy as np

from cuda_gcn_torch.data import native
from cuda_gcn_torch.data.dataset import CSR, GCNDataset


def _lines(path: str) -> list[str]:
    with open(path, "r") as f:
        return f.read().splitlines()


def parse_graph_text(lines: list[str]) -> CSR:
    """The adjacency CSR, a self-loop first in every row (parser.cpp:20-46)."""
    n = len(lines)
    tokens = [line.split() for line in lines]
    counts = np.fromiter((len(t) + 1 for t in tokens), dtype=np.int64, count=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], dtype=np.int64)
    indices[indptr[:-1]] = np.arange(n, dtype=np.int64)  # the implicit self connection
    flat = (np.array([x for t in tokens for x in t], dtype=np.int64) if indptr[-1] > n
            else np.empty(0, np.int64))
    mask = np.ones(indptr[-1], dtype=bool)
    mask[indptr[:-1]] = False
    indices[mask] = flat
    return CSR(indptr=indptr.astype(np.int32), indices=indices.astype(np.int32))


def parse_svmlight_text(lines: list[str]):
    """``label k:v ...`` lines -> (feature CSR, values, labels, input_dim,
    output_dim), as parser.cpp:52-92."""
    indptr = np.zeros(len(lines) + 1, dtype=np.int64)
    idx_chunks: list[np.ndarray] = []
    val_chunks: list[np.ndarray] = []
    labels = np.full(len(lines), -1, dtype=np.int32)
    max_idx, max_label = 0, 0
    for i, line in enumerate(lines):
        parts = line.split()
        indptr[i + 1] = indptr[i]
        if not parts:
            continue
        try:
            label = int(parts[0])
        except ValueError:
            continue
        labels[i] = label
        max_label = max(max_label, label)
        if len(parts) > 1:
            kv = np.char.partition(np.asarray(parts[1:]), ":")
            ks = kv[:, 0].astype(np.int64)
            idx_chunks.append(ks)
            val_chunks.append(kv[:, 2].astype(np.float32))
            indptr[i + 1] += len(ks)
            max_idx = max(max_idx, int(ks.max()))
    indices = np.concatenate(idx_chunks) if idx_chunks else np.empty(0, np.int64)
    values = np.concatenate(val_chunks) if val_chunks else np.empty(0, np.float32)
    csr = CSR(indptr=indptr.astype(np.int32), indices=indices.astype(np.int32))
    return csr, values.astype(np.float32), labels, max_idx + 1, max_label + 1


def parse_split_text(lines: list[str]) -> np.ndarray:
    return np.array([int(line) for line in lines if line.strip()], dtype=np.int32)


def load_dataset(name: str, data_dir: str = "data",
                 use_native: bool | None = None) -> GCNDataset:
    """Load ``<data_dir>/<name>.{graph,split,svmlight}`` (parser.cpp:12-15).

    ``use_native``: None or True parse with the native parser, which raises
    if it cannot be built; False with the numpy parser (the JAX package's
    meaning, cuda_gcn_tpu/data/parser.py:155-173, less its silent fallback)."""
    paths = {ext: os.path.join(data_dir, f"{name}.{ext}")
             for ext in ("graph", "split", "svmlight")}
    for p in paths.values():
        if not os.path.exists(p):
            raise FileNotFoundError(f"Cannot read input: {p}")
    if use_native is not False:
        return native.load_dataset(paths)
    graph = parse_graph_text(_lines(paths["graph"]))
    feat, values, labels, input_dim, output_dim = parse_svmlight_text(
        _lines(paths["svmlight"]))
    split = parse_split_text(_lines(paths["split"]))
    return GCNDataset(graph=graph, feature_index=feat, feature_value=values, label=labels,
                      split=split, num_nodes=graph.nrows, input_dim=input_dim,
                      output_dim=output_dim)
