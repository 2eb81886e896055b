"""The port's partitioner and layout against the JAX package's
(cuda_gcn_tpu/parallel/partition.py, cuda_gcn_tpu/data/reorder.py) and its
rectangular operators against cuda_gcn_tpu.ops.graphsum.rect_graphsum.

Every index array of ``partition_graph`` equals JAX's bit for bit, padding
included, on ``tiny_dataset`` at P = 1, 2, 4, 8, with both balances, with and
without interior tiles (``bsr_tile=16`` as tests/test_parallel.py:111, f32
and bf16 tiles) and with explicit cuts; the tiles themselves equal JAX's
value for value. ``rect_graphsum`` forward and backward agree with JAX's on
each part's interior (tiles and residual) and boundary (n_in = halo_space)
within rtol 1e-5 / atol 1e-6: the same f32 terms summed in another order.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu.data import reorder as jreorder
from cuda_gcn_tpu.ops.graphsum import RectGraph as JRect
from cuda_gcn_tpu.ops.graphsum import rect_graphsum as jrect_graphsum
from cuda_gcn_tpu.parallel import partition as jpart

from cuda_gcn_torch.data import reorder as treorder
from cuda_gcn_torch.data.dataset import CSR
from cuda_gcn_torch.ops.graphsum import rect_graphsum
from cuda_gcn_torch.parallel import partition as tpart
from cuda_gcn_torch.parallel import sharded as tsharded

TILES = {"none": {}, "f32": dict(interior_tiles=True, bsr_tile=16, bsr_min_edges=4,
                                 bsr_dtype="float32"),
         "bf16": dict(interior_tiles=True, bsr_tile=16, bsr_min_edges=4)}
EDGE_ARRAYS = ("i_src", "i_dst", "i_coef", "it_src", "it_dst", "it_coef", "b_src", "b_dst",
               "b_coef", "bt_src", "bt_dst", "bt_coef")
ARRAYS = ("starts", "off_start") + EDGE_ARRAYS
SCALARS = ("n_parts", "block", "n_nodes", "halo_space", "hmax_k", "eimax", "ebmax")


def _csr(ds):
    return CSR(np.asarray(ds.graph.indptr), np.asarray(ds.graph.indices))


def _jax_tiles(pg) -> np.ndarray:
    return np.asarray(pg.i_tiles).astype(np.float32)


def assert_partitions_equal(t, j):
    for name in SCALARS:
        assert getattr(t, name) == getattr(j, name), name
    for name in ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(t.send_secs) == len(j.send_secs) == t.n_parts - 1
    for a, b in zip(t.send_secs, j.send_secs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if j.i_tiles is None:
        assert t.tb == 0 and t.i_tile_rows is None
        return
    assert (t.tb, t.i_nblocks) == (j.tb, j.i_nblocks)
    np.testing.assert_array_equal(t.i_tile_rows, j.i_tile_rows)
    np.testing.assert_array_equal(t.i_tile_cols, j.i_tile_cols)
    jt = _jax_tiles(j)
    for p in range(t.n_parts):
        k = int(t.i_tile_counts[p])
        got = t.part(p).tiles("cpu").float().numpy()
        np.testing.assert_array_equal(got, jt[p, :k])
        assert not jt[p, k:].any()  # JAX's padding tiles are zero


@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("balance", ["nodes", "edges"])
@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_partition_graph_equals_jax(tiny_dataset, n_parts, balance, tiles):
    j = jpart.partition_graph(tiny_dataset.graph, n_parts, balance=balance, **TILES[tiles])
    t = tpart.partition_graph(_csr(tiny_dataset), n_parts, balance=balance, **TILES[tiles])
    assert_partitions_equal(t, j)
    if tiles != "none" and n_parts <= 2:
        assert int(t.i_tile_counts.sum()) > 0  # the case builds tiles


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_partition_graph_with_layout_cuts_equals_jax(tiny_dataset, n_parts):
    """Explicit cuts, as prepare_sharded passes them: partition_layout's
    relabelling, then the graph cut there."""
    from cuda_gcn_torch.data.dataset import reorder_dataset
    from test_torch_train import to_torch_dataset

    ds = to_torch_dataset(tiny_dataset)
    labels = treorder.label_propagation(ds.graph.indptr, ds.graph.indices)
    deg = np.diff(ds.graph.indptr.astype(np.int64))
    perm, cuts = treorder.partition_layout(ds.graph.indptr, ds.graph.indices, labels,
                                           n_parts, weights=deg)
    g = reorder_dataset(ds, perm).graph
    j = jpart.partition_graph(jpart.CSR(g.indptr, g.indices), n_parts, cuts=cuts,
                              **TILES["f32"])
    assert_partitions_equal(tpart.partition_graph(g, n_parts, cuts=cuts, **TILES["f32"]), j)
    with pytest.raises(ValueError, match="cuts must be"):
        tpart.partition_graph(g, n_parts, cuts=np.zeros(n_parts, np.int64))


def _hub_indptr(n=16, hub=-1):
    deg = np.ones(n, np.int64)
    deg[hub] = 1000
    return np.concatenate([[0], np.cumsum(deg)])


@pytest.mark.parametrize("case", ["tiny", "tiny-clusters", "hub-end", "hub-front"])
@pytest.mark.parametrize("balance", ["nodes", "edges"])
@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_partition_cuts_equal_jax(tiny_dataset, n_parts, balance, case):
    indptr = {"tiny": np.asarray(tiny_dataset.graph.indptr),
              "tiny-clusters": np.asarray(tiny_dataset.graph.indptr),
              "hub-end": _hub_indptr(), "hub-front": _hub_indptr(hub=0)}[case]
    clusters = (np.array([60, 50, 40, 30, 20]) if case == "tiny-clusters" else None)
    want = jpart.partition_cuts(indptr, n_parts, balance, clusters)
    got = tpart.partition_cuts(indptr, n_parts, balance, clusters)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (np.diff(np.append(got, len(indptr) - 1)) > 0).all()


def _labels(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "tail":  # 4 big clusters and 200 tiny ones (tests/test_parallel.py:363)
        labels = np.concatenate([np.repeat(np.arange(4), 800),
                                 np.repeat(np.arange(4, 204), 6)])
    else:  # one cluster of ~70% of the weight (tests/test_parallel.py:397)
        labels = np.concatenate([np.zeros(7000, np.int64), np.repeat(np.arange(1, 101), 30)])
    labels = labels[rng.permutation(len(labels))]
    return labels, rng.integers(1, 10, len(labels)).astype(np.int64)


@pytest.mark.parametrize("kind", ["tail", "giant"])
@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_partition_aware_order_equals_jax(kind, n_parts):
    labels, weights = _labels(kind, 2 if kind == "tail" else 7)
    for w in (weights, None):
        jp, jc = jreorder.partition_aware_order(labels, n_parts, weights=w)
        tp, tc = treorder.partition_aware_order(labels, n_parts, weights=w)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tc, jc)
        assert tc.dtype == jc.dtype


def _planted(n, seed, p_in=0.05, p_out=0.005):
    rng = np.random.default_rng(seed)
    blocks = (np.arange(n) >= n // 2).astype(np.int64)
    a = rng.random((n, n))
    adj = np.where(blocks[:, None] == blocks[None, :], a < p_in, a < p_out)
    adj |= adj.T
    np.fill_diagonal(adj, True)
    indptr = np.concatenate([[0], np.cumsum(adj.sum(1))]).astype(np.int64)
    return indptr, (np.flatnonzero(adj.ravel()) % n).astype(np.int32), blocks


@pytest.mark.parametrize("sweeps,slack", [(2, 1.05), (8, 1.05), (4, 1.2)])
def test_refine_partition_equals_jax(sweeps, slack):
    indptr, indices, blocks = _planted(400, 3)
    n = len(indptr) - 1
    rng = np.random.default_rng(0)
    start = np.where(rng.random(n) < 0.3, blocks, rng.integers(0, 2, n)).astype(np.int32)
    w = np.diff(indptr).astype(np.float64)
    want = jreorder.refine_partition(indptr, indices, start, 2, w, sweeps=sweeps, slack=slack)
    got = treorder.refine_partition(indptr, indices, start, 2, w, sweeps=sweeps, slack=slack)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_partition_layout_equals_jax(n_parts):
    indptr, indices, _ = _planted(600, 5)
    labels = jreorder.label_propagation(indptr, indices, prefer_native=False)
    np.testing.assert_array_equal(treorder.label_propagation(indptr, indices), labels)
    deg = np.diff(indptr).astype(np.int64)
    jp, jc = jreorder.partition_layout(indptr, indices, labels, n_parts, weights=deg)
    tp, tc = treorder.partition_layout(indptr, indices, labels, n_parts, weights=deg)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tc, jc)


def _jax_rects(pg, p):
    """Part p's interior and boundary as the JAX package's RectGraphs."""
    tiles = {}
    if pg.i_tiles is not None:
        tiles = dict(tiles=jnp.asarray(pg.i_tiles[p]), tile_rows=jnp.asarray(pg.i_tile_rows[p]),
                     tile_cols=jnp.asarray(pg.i_tile_cols[p]), tb=pg.tb, nblocks=pg.i_nblocks)
    a = {k: jnp.asarray(getattr(pg, k)[p]) for k in EDGE_ARRAYS}
    interior = JRect(a["i_src"], a["i_dst"], a["i_coef"], a["it_src"], a["it_dst"],
                             a["it_coef"], n_out=pg.block, n_in=pg.block, **tiles)
    boundary = JRect(a["b_src"], a["b_dst"], a["b_coef"], a["bt_src"], a["bt_dst"],
                             a["bt_coef"], n_out=pg.block, n_in=pg.halo_space)
    return interior, boundary


@pytest.mark.parametrize("tiles", ["none", "f32", "bf16"])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_rect_graphsum_matches_jax(tiny_dataset, n_parts, tiles):
    j = jpart.partition_graph(tiny_dataset.graph, n_parts, **TILES[tiles])
    t = tpart.partition_graph(_csr(tiny_dataset), n_parts, **TILES[tiles])
    rng = np.random.default_rng(n_parts)
    d = 6
    for p in range(n_parts):
        part = t.part(p)
        ex = tsharded.HaloExchange(p, n_parts, part.hmax_k)
        inputs = tsharded.make_sharded_inputs(part, np.zeros((part.block, 3), np.float32),
                                              "cpu", ex)
        assert inputs.interior.square.backend == ("segment" if tiles == "none" else "bsr")
        for which, (t_rg, j_rg) in zip(("interior", "boundary"),
                                       zip((inputs.interior, inputs.boundary),
                                           _jax_rects(j, p))):
            assert (t_rg.n_out, t_rg.n_in) == (j_rg.n_out, j_rg.n_in)
            h = rng.standard_normal((j_rg.n_in, d)).astype(np.float32)
            g = rng.standard_normal((j_rg.n_out, d)).astype(np.float32)
            y_j, pull = jax.vjp(lambda a: jrect_graphsum(a, j_rg), jnp.asarray(h))
            (dh_j,) = pull(jnp.asarray(g))
            ht = torch.from_numpy(h).requires_grad_()
            y_t = rect_graphsum(ht, t_rg)
            (dh_t,) = torch.autograd.grad(y_t, ht, torch.from_numpy(g))
            np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{which} forward, part {p}")
            np.testing.assert_allclose(dh_t.numpy(), np.asarray(dh_j), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{which} backward, part {p}")
            assert np.abs(np.asarray(y_j)).max() > 0


def test_part_views_drop_only_padding(tiny_dataset):
    """A part's view holds its real edges and tiles: the padding edges are
    coefficient 0 and the padding tiles zero, so they add nothing."""
    t = tpart.partition_graph(_csr(tiny_dataset), 4, **TILES["f32"])
    total = 0
    for p in range(4):
        v = t.part(p)
        ki, kb = len(v.interior[0]), len(v.boundary[0])
        assert not t.i_coef[p, ki:].any() and not t.b_coef[p, kb:].any()
        assert (v.interior[2] > 0).all() and (v.boundary[2] > 0).all()
        total += ki + kb + len(v.tile_vals)
        back = pickle.loads(pickle.dumps(v))  # a launcher pickles it for its rank
        np.testing.assert_array_equal(back.boundary_t[1], v.boundary_t[1])
    assert total == tiny_dataset.graph.nnz


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_sparse_features_parts_equal_jax_and_the_dense_slabs(tiny_dataset, n_parts):
    """make_sparse_features_parts: each part's CSR rows hold JAX's padded COO
    (cuda_gcn_tpu/ops/matmul.py:258) without its padding, and X·W on them is
    the part's dense [block, F] slab times W."""
    from cuda_gcn_tpu.ops.matmul import make_sparse_features_parts as jparts

    from cuda_gcn_torch.ops.matmul import csr_matmul, make_sparse_features_parts

    ds = tiny_dataset
    t = tpart.partition_graph(_csr(ds), n_parts)
    fi = ds.feature_index
    args = (np.asarray(fi.indptr), np.asarray(fi.indices), ds.feature_value, t.bounds,
            t.block, ds.input_dim)
    want = jparts(*args, np.float32)
    parts = make_sparse_features_parts(*args, torch.float32, "cpu")
    x = t.pad_nodes(ds.dense_features())
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((ds.input_dim, 5))
                         .astype(np.float32))
    assert len(parts) == n_parts
    for p, sf in enumerate(parts):
        k = sf.nnz
        assert sf.n_rows == t.block and not np.asarray(want.values)[p, k:].any()
        np.testing.assert_array_equal(sf.rows.numpy(), np.asarray(want.rows)[p, :k])
        np.testing.assert_array_equal(sf.cols.numpy(), np.asarray(want.cols)[p, :k])
        np.testing.assert_array_equal(sf.values.numpy(), np.asarray(want.values)[p, :k])
        dense = torch.from_numpy(x[p * t.block:(p + 1) * t.block]) @ w
        np.testing.assert_allclose(csr_matmul(sf.values, sf, w).numpy(), dense.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device,n_parts,cards,sharing", [
    (None, 4, 0, 4), ("cpu", 4, 1, 4),            # host memory: all parts share it
    ("cuda", 1, 1, 1), ("cuda", 4, 1, 4),         # gloo ranks sharing one card
    ("cuda", 2, 2, 1), ("cuda", 4, 4, 1),         # NCCL: one card a rank
    ("cuda", 4, 2, 2)])
def test_ranks_per_card_follows_the_cards(monkeypatch, device, n_parts, cards, sharing):
    """A part's share of the tile budget: the parts spread over the cards
    there are, and off the card they all share the host."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tpart._ranks_per_card(n_parts, device) == sharing
