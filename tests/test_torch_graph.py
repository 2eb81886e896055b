"""The port's graph build (cuda_gcn_torch/data) against the JAX package's.

Same CSR in, same tiles (bitwise, f32 and bf16), tile ids, residual edges and
transpose out; plus the dataset loader, relabelling and tile budget.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_gcn_tpu.data import graph as jgraph
from cuda_gcn_tpu.data.parser import CSR as JCSR
from cuda_gcn_tpu.data.reorder import locality_permutation
from cuda_gcn_tpu.data.reorder import reorder_dataset as j_reorder
from cuda_gcn_tpu.data.synthetic import SynthSpec, make_synthetic

from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import graph as tgraph


@pytest.fixture(scope="module")
def clustered():
    """tests/test_bsr.py's community graph, relabelled for dense diagonal tiles."""
    spec = SynthSpec(num_nodes=256, num_edges=4000, num_classes=4, input_dim=16,
                     nnz_per_node=4, homophily=0.9, train_per_class=10,
                     num_val=40, num_test=60)
    ds = make_synthetic(spec, seed=11)
    return j_reorder(ds, locality_permutation(ds.graph)).dataset


def asymmetric_csr():
    """tests/test_bsr.py:454's directed graph (self-loops included)."""
    rng = np.random.default_rng(7)
    rows = [np.sort(np.unique(np.append(rng.integers(0, 96, rng.integers(1, 6)), i)))
            for i in range(96)]
    indptr = np.zeros(97, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    return JCSR(indptr, np.concatenate(rows).astype(np.int64))


def tcsr(csr):
    return tds.CSR(np.asarray(csr.indptr), np.asarray(csr.indices))


def resid_coo(resid):
    row_ptr = resid.row_ptr.numpy().astype(np.int64)
    src = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    return src, resid.cols.numpy(), resid.coef.numpy()


def tile_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def jax_tile_bits(t):
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def assert_same_bsr(csr, **kw):
    kw = {"bsr_tile": 32, "bsr_min_edges": 8, **kw}
    jg = jgraph.build_graph(csr, backend="bsr", **kw)
    tg = tgraph.build_graph(tcsr(csr), backend="bsr", device="cpu", **kw)
    assert tg.symmetric == jg.symmetric
    assert (tg.tb, tg.t_blocks) == (jg.bsr_tb, jg.bsr_nblocks)
    np.testing.assert_array_equal(tg.tile_rows.numpy(), np.asarray(jg.bsr_rows))
    np.testing.assert_array_equal(tg.tile_cols.numpy(), np.asarray(jg.bsr_cols))
    np.testing.assert_array_equal(tile_bits(tg.tiles), jax_tile_bits(jg.bsr_tiles))
    src, dst, coef = resid_coo(tg.resid)
    np.testing.assert_array_equal(src, np.asarray(jg.src))
    np.testing.assert_array_equal(dst, np.asarray(jg.dst))
    np.testing.assert_array_equal(coef, np.asarray(jg.coef))
    assert tg.total_nnz == jg.total_nnz and tg.resid_nnz == jg.resid_nnz
    return jg, tg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bsr_tiles_and_residual_match_jax(clustered, dtype):
    jg, tg = assert_same_bsr(clustered.graph, bsr_dtype=dtype)
    assert tg.num_tiles > 0 and tg.resid_nnz > 0
    assert tg.tiles.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert tg.symmetric and tg.resid_t is None and tg.plan_t is None


@pytest.mark.parametrize("budget_tiles", [1, 3, 5])
def test_pair_closure_matches_jax(clustered, budget_tiles):
    """A budget that cuts a mirror pair drops the unpaired tile, as in
    tests/test_bsr.py:436."""
    _, tg = assert_same_bsr(clustered.graph, bsr_dtype="float32",
                            bsr_budget_bytes=budget_tiles * 32 * 32 * 4)
    key = set(zip(tg.tile_rows.tolist(), tg.tile_cols.tolist()))
    assert all((c, r) in key for r, c in key)


def test_asymmetric_graph_builds_transpose_like_jax():
    csr = asymmetric_csr()
    jg, tg = assert_same_bsr(csr, bsr_dtype="float32", bsr_min_edges=2)
    assert not tg.symmetric
    src, dst, coef = resid_coo(tg.resid_t)
    np.testing.assert_array_equal(src, np.asarray(jg.t_src))
    np.testing.assert_array_equal(dst, np.asarray(jg.t_dst))
    np.testing.assert_array_equal(coef, np.asarray(jg.t_coef))
    # the transposed plan groups tiles by block column
    plan = tg.plan_t
    cols = tg.tile_cols.numpy()
    order = plan.order.numpy()
    np.testing.assert_array_equal(cols[order], np.sort(cols))
    np.testing.assert_array_equal(plan.hblk.numpy(), tg.tile_rows.numpy()[order])


def test_segment_and_dense_backends_match_jax(clustered):
    csr = clustered.graph
    jg = jgraph.build_graph(csr, backend="segment")
    tg = tgraph.build_graph(tcsr(csr), backend="segment", device="cpu")
    src, dst, coef = resid_coo(tg.resid)
    np.testing.assert_array_equal(src, np.asarray(jg.src))
    np.testing.assert_array_equal(dst, np.asarray(jg.dst))
    np.testing.assert_array_equal(coef, np.asarray(jg.coef))
    jd = jgraph.build_graph(csr, backend="dense")
    td = tgraph.build_graph(tcsr(csr), backend="dense", device="cpu")
    np.testing.assert_array_equal(td.adj.numpy(), np.asarray(jd.adj))


def test_normalization_and_budget_match_jax(clustered):
    csr = clustered.graph
    indptr = np.asarray(csr.indptr, np.int64)
    indices = np.asarray(csr.indices, np.int64)
    np.testing.assert_array_equal(tgraph.normalization_coefficients(indptr, indices),
                                  jgraph.normalization_coefficients(indptr, indices))
    for sym in (True, False):
        for args in ((232965, 20978489, 602 * 232965 * 4, 80 << 30),
                     (1000, 5000, 0, 2 << 30)):
            assert (tgraph.auto_tile_budget(*args, symmetric=sym)
                    == jgraph.auto_tile_budget(args[0], args[1], args[2],
                                               hbm_bytes=args[3], symmetric=sym))
    # small graphs resolve to the 1 GB floor without asking the device
    assert tgraph.resolve_tile_budget(256, 4000, 32, 2, None, 0, True, 4,
                                      torch.device("cpu")) == 1 << 30


def test_reorder_and_dense_features_match_jax(tiny_dataset):
    perm = np.random.default_rng(0).permutation(tiny_dataset.num_nodes)
    ds = tds.GCNDataset(graph=tcsr(tiny_dataset.graph),
                        feature_index=tcsr(tiny_dataset.feature_index),
                        feature_value=tiny_dataset.feature_value,
                        label=tiny_dataset.label, split=tiny_dataset.split,
                        num_nodes=tiny_dataset.num_nodes,
                        input_dim=tiny_dataset.input_dim,
                        output_dim=tiny_dataset.output_dim)
    got = tds.reorder_dataset(ds, perm)
    want = j_reorder(tiny_dataset, perm).dataset
    for a, b in ((got.graph.indptr, want.graph.indptr),
                 (got.graph.indices, want.graph.indices),
                 (got.feature_index.indptr, want.feature_index.indptr),
                 (got.feature_index.indices, want.feature_index.indices),
                 (got.feature_value, want.feature_value),
                 (got.label, want.label), (got.split, want.split)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.dense_features(), want.dense_features())


def test_cache_loader_matches_bench_loader():
    """load_cached + reorder_cached read the .cache files as bench.py does."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import bench

    want = bench.maybe_reorder_cached(
        bench.load_bench_dataset("synth-pubmed", "no-such-dir")[0], "synth-pubmed")
    got = tds.reorder_cached(tds.load_cached("synth-pubmed"), "synth-pubmed")
    assert (got.num_nodes, got.input_dim, got.output_dim) == (
        want.num_nodes, want.input_dim, want.output_dim)
    np.testing.assert_array_equal(got.graph.indices, want.graph.indices)
    np.testing.assert_array_equal(got.feature_value, want.feature_value)
    np.testing.assert_array_equal(got.label, want.label)
    with pytest.raises(FileNotFoundError, match="no cached locality permutation"):
        tds.reorder_cached(got, "synth-cora")
