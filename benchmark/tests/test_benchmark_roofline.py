"""The gcn family's roofline (``job_work``, benchmark/roofline.py's ``Work``)
against hand counts, and one graph built as bsr, segment and ell read as one
count."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import registry, roofline, synth

gcn = registry.family("gcn")

TINY = gcn.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(8, 4, 3))


def test_adjacency_pass_by_hand():
    w = gcn.adjacency_pass(TINY, 4)
    # 30 column indices + 11 row pointers, h and out 10x4 f32 each
    assert w.bytes == 30 * 4 + 11 * 4 + 2 * 10 * 4 * 4
    assert w.flops == 2 * 30 * 4


def test_fused_epoch_by_hand():
    per = gcn.epoch(TINY, early_stopping=False)
    passes = sum(30 * 4 + 11 * 4 + 2 * 10 * d * 4 for d in (8, 6, 3, 4))
    assert per["aggregation"].bytes == passes
    assert per["aggregation"].flops == 2 * 30 * (8 + 6 + 3 + 4)
    # dense x (10x8 f32) read for the pair and for dW; three products' operations
    assert per["layer0"].bytes == 2 * 10 * 8 * 4
    assert per["layer0"].flops == 3 * 2 * 10 * 8 * 4


def test_early_stopping_epoch_by_hand():
    per = gcn.epoch(TINY, early_stopping=True)
    assert per["aggregation"].flops == 2 * 30 * (4 + 3 + 3 + 4 + 4 + 3)
    assert per["layer0"].bytes == 3 * 10 * 8 * 4


def test_sparse_features_by_hand():
    s = gcn.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(8, 4, 3),
                        feature_matmul="sparse")
    one = gcn.layer0_read(s)
    assert one.bytes == 25 * (4 + 4) + 11 * 4
    assert one.flops == 2 * 25 * 4


def test_job_and_least_time():
    job = gcn.job_work(TINY, epochs=5, early_stopping=False)
    ev = gcn.evaluation(TINY)
    per = gcn.epoch(TINY, False)
    assert job["aggregation"].bytes == 5 * per["aggregation"].bytes + 2 * ev["aggregation"].bytes
    total = job["total"]
    assert total.least_s("float32") == max(total.bytes / roofline.HBM_BYTES_PER_S,
                                           total.flops / roofline.PEAK_FLOPS["float32"])


def test_three_layers_by_hand():
    """At two hidden layers the passes run at every width: forward at twice
    each width, backward from the last; layer 0 reads x at the first hidden
    width's operations."""
    s = gcn.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(8, 4, 5, 3))
    fused = gcn.epoch(s, early_stopping=False)
    assert fused["aggregation"].flops == 2 * 30 * (8 + 10 + 6 + 3 + 5 + 4)
    assert fused["layer0"].flops == 3 * 2 * 10 * 8 * 4
    es = gcn.epoch(s, early_stopping=True)
    assert es["aggregation"].flops == 2 * 30 * (4 + 5 + 3 + 3 + 5 + 4 + 4 + 5 + 3)
    assert gcn.evaluation(s)["aggregation"].flops == 2 * 30 * (4 + 5 + 3)


def test_sparse_features_name_their_spmm_part():
    dense = gcn.job_work(TINY, 5, False)
    assert set(dense) == {"aggregation", "layer0", "total"}
    sparse = gcn.job_work(gcn.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(8, 4, 3),
                                     feature_matmul="sparse"), 5, False)
    assert sparse["layer0_spmm"] == sparse["layer0"]


def test_bf16_halves_activation_bytes():
    s16 = gcn.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(8, 4, 3), dtype="bfloat16")
    assert gcn.adjacency_pass(s16, 4).bytes == 30 * 4 + 11 * 4 + 2 * 10 * 4 * 2


def test_reddit_epoch_least():
    """The issue's numbers: an fp32 fused epoch of synth-reddit needs about
    0.53 ms, its four passes about 0.195 ms."""
    s = gcn.Shapes(nodes=232965, nnz=20978489, feature_nnz=4077832, dims=(602, 16, 41))
    per = gcn.epoch(s, False)
    assert math.isclose(per["aggregation"].least_s("float32") * 1e3, 0.195, rel_tol=0.01)
    total = per["aggregation"] + per["layer0"]
    assert math.isclose(total.least_s("float32") * 1e3, 0.530, rel_tol=0.01)


@pytest.mark.parametrize("backend", ["bsr", "segment", "ell"])
def test_count_reads_no_layout(backend):
    """The same graph built for three backends gives one count: the count
    takes the node count, the nnz and the widths, which every build keeps."""
    from cuda_gcn_torch.data.dataset import CSR
    from cuda_gcn_torch.data.graph import build_graph

    spec = synth.spec_for(3000, 30000, 4, 16, nnz_per_node=4)
    d = synth.make_synthetic(spec, seed=5)
    g = build_graph(CSR(d["indptr"], d["indices"]), backend=backend, device="cpu",
                    bsr_min_edges=8)
    if backend == "bsr":
        assert g.num_tiles > 0  # part of the edges live in tiles
    s = gcn.Shapes(nodes=g.n_nodes, nnz=g.total_nnz, feature_nnz=len(d["f_values"]),
                        dims=(16, 16, 4))
    expect = gcn.Shapes(nodes=3000, nnz=int(d["indptr"][-1]),
                             feature_nnz=int(d["f_indptr"][-1]), dims=(16, 16, 4))
    assert gcn.job_work(s, 100, False)["total"] == gcn.job_work(expect, 100, False)["total"]
    assert np.isclose(gcn.job_work(s, 100, False)["total"].least_s("float32"),
                      gcn.job_work(expect, 100, False)["total"].least_s("float32"))
