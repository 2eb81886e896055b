"""Host-side dataset containers, the locality relabelling and the cache loader.

Copies of what the port needs from the JAX package's numpy modules, which it
cannot import (cuda_gcn_tpu/data/__init__.py pulls in jax):

* ``CSR`` and ``GCNDataset`` with ``dense_features``/``apply_config``
  (cuda_gcn_tpu/data/parser.py:36-89);
* ``reorder_dataset`` (cuda_gcn_tpu/data/reorder.py:318-364; data/reorder.py
  re-exports it beside the LPA that computes a permutation);
* ``load_cached`` and ``reorder_cached``: the ``.cache/<synth-name>.npz`` and
  ``.perm.npy`` loaders that bench.py:39-91 uses. A missing permutation cache
  raises here; ``train.prepare`` computes the permutation instead.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from cuda_gcn_torch.config import GCNConfig

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache")


@dataclasses.dataclass
class CSR:
    """Index-only CSR structure (reference ``SparseIndex``, src/seq/sparse.h:12-17)."""

    indptr: np.ndarray   # (nrows+1,) int32
    indices: np.ndarray  # (nnz,) int32

    @property
    def nrows(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


@dataclasses.dataclass
class GCNDataset:
    """Parsed dataset (reference ``GCNData``, src/seq/gcn.h:16-22)."""

    graph: CSR              # adjacency CSR, self-loops already prepended
    feature_index: CSR      # sparse feature CSR index
    feature_value: np.ndarray  # (feature nnz,) float32
    label: np.ndarray       # (num_nodes,) int32, -1 where unlabeled
    split: np.ndarray       # (num_nodes,) int32, 1/2/3 codes
    num_nodes: int
    input_dim: int
    output_dim: int

    def dense_features(self, dtype=np.float32) -> np.ndarray:
        """Densify the CSR feature matrix to [num_nodes, input_dim]."""
        x = np.zeros((self.num_nodes, self.input_dim), dtype=dtype)
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int64),
                         np.diff(self.feature_index.indptr))
        x[rows, self.feature_index.indices] = self.feature_value.astype(dtype)
        return x

    def apply_config(self, cfg: GCNConfig) -> GCNConfig:
        """Overwrite the parser-inferred fields of a config (main.cpp:29-33 flow)."""
        return dataclasses.replace(cfg, num_nodes=self.num_nodes,
                                   input_dim=self.input_dim,
                                   output_dim=self.output_dim)


def _permute_csr(indptr: np.ndarray, perm: np.ndarray):
    """Row permutation of a CSR: (new indptr, gather index into the old values)."""
    deg = np.diff(indptr.astype(np.int64))
    new_deg = deg[perm]
    new_indptr = np.zeros(len(perm) + 1, dtype=np.int64)
    np.cumsum(new_deg, out=new_indptr[1:])
    starts = indptr.astype(np.int64)[perm]
    gather = (np.repeat(starts - new_indptr[:-1], new_deg)
              + np.arange(new_indptr[-1], dtype=np.int64))
    return new_indptr, gather


def reorder_dataset(ds: GCNDataset, perm: np.ndarray) -> GCNDataset:
    """Relabel every per-node structure by ``perm`` (perm[new_id] = old_id)."""
    n = ds.num_nodes
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    # adjacency: rows permuted, column ids remapped (row content order preserved)
    g_indptr, g_gather = _permute_csr(ds.graph.indptr, perm)
    new_indices = inv[ds.graph.indices.astype(np.int64)[g_gather]]
    graph = CSR(indptr=g_indptr.astype(np.int32), indices=new_indices.astype(np.int32))
    f_indptr, f_gather = _permute_csr(ds.feature_index.indptr, perm)
    feature_index = CSR(indptr=f_indptr.astype(np.int32),
                        indices=ds.feature_index.indices[f_gather])
    return GCNDataset(graph=graph, feature_index=feature_index,
                      feature_value=ds.feature_value[f_gather],
                      label=ds.label[perm], split=ds.split[perm], num_nodes=n,
                      input_dim=ds.input_dim, output_dim=ds.output_dim)


def load_cached(name: str, cache_dir: str = CACHE_DIR) -> GCNDataset:
    """Load ``<cache_dir>/<name>.npz`` (field names as bench.py:55-61 writes them)."""
    path = os.path.join(cache_dir, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot read input: {path}")
    with np.load(path) as z:
        return GCNDataset(
            graph=CSR(z["g_indptr"], z["g_indices"]),
            feature_index=CSR(z["f_indptr"], z["f_indices"]),
            feature_value=z["f_values"], label=z["label"], split=z["split"],
            num_nodes=int(z["num_nodes"]), input_dim=int(z["input_dim"]),
            output_dim=int(z["output_dim"]))


def cached_permutation_path(name: str, cache_dir: str = CACHE_DIR) -> str:
    return os.path.join(cache_dir, f"{name}.perm.npy")


def reorder_cached(ds: GCNDataset, name: str, cache_dir: str = CACHE_DIR) -> GCNDataset:
    """Relabel ``ds`` with the cached locality permutation ``<name>.perm.npy``
    (bench.py:75-91). A missing one raises: train.prepare computes the
    permutation (data/reorder.py) when ``reorder`` is not 'none'."""
    perm_path = cached_permutation_path(name, cache_dir)
    if not os.path.exists(perm_path):
        raise FileNotFoundError(
            f"no cached locality permutation {perm_path}; train with "
            f"reorder='auto' to compute one")
    return reorder_dataset(ds, np.load(perm_path))
