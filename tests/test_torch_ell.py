"""The port's ell/pallas backends against the JAX package's, on the CPU.

The ELL packing must equal the JAX build bit for bit (buckets, bucket order,
pads), forward and, for an asymmetric Â, transpose. Kernel 3's plain version
is held against the interpret-mode Pallas kernel (cuda_gcn_tpu/ops/
pallas_spmm.py ``ell_spmm``, as tests/test_ops.py runs it), graphsum and its
gradient against JAX graphsum on the same backend, and a short training run
against JAX ``train.run``. The work list that kernel 3 walks is restated in
numpy, in each of the orders its items can be listed in. Tolerances: atol 1e-5, rtol 1e-5 in f32, where only the summation
order differs; the training run as tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.data import graph as jgraph
from cuda_gcn_tpu.data.parser import CSR as JCSR
from cuda_gcn_tpu.ops import pallas_spmm
from cuda_gcn_tpu.ops.graphsum import graphsum as jgraphsum

from cuda_gcn_torch import convert
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import graph as tgraph
from cuda_gcn_torch.ops import ell as tell
from cuda_gcn_torch.ops import graphsum as tgs

RTOL, ATOL = 1e-5, 1e-5
HUB_DEGREE = 600  # above 512: a pow2 bucket of width 1024, and chunked work items


def hub_csr(symmetric: bool, n: int = 640, seed: int = 5) -> JCSR:
    """A random graph (about 3 edges per node, self-loops prepended) with one
    hub row of HUB_DEGREE neighbors; the asymmetric one also has a node that
    HUB_DEGREE - 50 others point to, so its transpose has a wide row too."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), 3)
    dst = rng.integers(0, n, len(src))
    hub = rng.choice(np.arange(1, n), HUB_DEGREE, replace=False)
    src = np.concatenate([src, np.zeros(HUB_DEGREE, np.int64)])
    dst = np.concatenate([dst, hub])
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    else:
        sink = rng.choice(np.arange(2, n), HUB_DEGREE - 50, replace=False)
        src = np.concatenate([src, sink])
        dst = np.concatenate([dst, np.ones(len(sink), np.int64)])
    rows = []
    for i in range(n):
        nb = np.unique(dst[(src == i) & (dst != i)])
        rows.append(np.concatenate([[i], nb]))
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    return JCSR(indptr.astype(np.int32), np.concatenate(rows).astype(np.int32))


@pytest.fixture(scope="module", params=["symmetric", "asymmetric"])
def graphs(request):
    csr = hub_csr(request.param == "symmetric")
    jg = jgraph.build_graph(csr, backend="pallas")
    tg = tgraph.build_graph(tds.CSR(np.asarray(csr.indptr), np.asarray(csr.indices)),
                            backend="pallas", device="cpu")
    return csr, jg, tg


def assert_same_buckets(plan, jbuckets):
    got = plan.host_buckets()
    assert len(got) == len(jbuckets)
    for a, b in zip(got, jbuckets):
        assert a.width == b.cols.shape[1]
        np.testing.assert_array_equal(a.rows, np.asarray(b.rows))
        np.testing.assert_array_equal(a.cols, np.asarray(b.cols))
        np.testing.assert_array_equal(a.coef.view(np.int32), np.asarray(b.coef).view(np.int32))


def test_ell_buckets_match_jax(graphs):
    csr, jg, tg = graphs
    assert tg.symmetric == jg.symmetric and tg.resid is None
    assert max(tg.ell.widths) >= 1024 and tg.ell.n_partials > 0
    assert_same_buckets(tg.ell, jg.ell_fwd)
    if tg.symmetric:
        assert tg.ell_t is None and jg.ell_bwd == ()
    else:
        assert max(tg.ell_t.widths) >= 512
        assert_same_buckets(tg.ell_t, jg.ell_bwd)
    assert tg.ell.nnz == csr.nnz == tg.total_nnz


def kernel_restated(plan: tell.EllPlan, h: np.ndarray) -> np.ndarray:
    """csrc/ell_spmm.cu in numpy: the items are taken in the order listed, each
    sums its slots into its output row or its partial; then each chunked row
    adds its partials in chunk order. Every output row must be written exactly
    once, every partial exactly once, and no pad slot read."""
    cols, coef = plan.cols.numpy(), plan.coef.numpy()
    out = np.full((plan.n_nodes, h.shape[1]), np.nan, np.float32)
    partial = np.full((plan.n_partials, h.shape[1]), np.nan, np.float32)
    writes = np.zeros(plan.n_nodes, np.int64)
    partial_writes = np.zeros(plan.n_partials, np.int64)
    for beg, ln, dst in zip(plan.work_beg.tolist(), plan.work_len.tolist(),
                            plan.work_dst.tolist()):
        assert 0 <= ln <= tell.ELL_CHUNK_SLOTS
        assert (coef[beg:beg + ln] != 0).all()
        s = (coef[beg:beg + ln, None] * h[cols[beg:beg + ln]]).sum(0)
        if dst >= 0:
            out[dst] = s
            writes[dst] += 1
        else:
            partial[-dst - 1] = s
            partial_writes[-dst - 1] += 1
    ptr = plan.split_ptr.numpy()
    for i, r in enumerate(plan.split_rows.tolist()):
        acc = np.zeros(h.shape[1], np.float32)
        for p in range(ptr[i], ptr[i + 1]):  # in chunk order
            acc = acc + partial[p]
        out[r] = acc
        writes[r] += 1
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(partial_writes, 1)
    return out


@pytest.mark.parametrize("order", tell.ORDERS)
@pytest.mark.parametrize("d", [3, 6, 16, 41, 82])
def test_work_list_restates_the_kernel(graphs, d, order):
    _, _, tg = graphs
    h = np.random.default_rng(d).standard_normal((tg.n_nodes, d)).astype(np.float32)
    for plan in filter(None, (tg.ell, tg.ell_t)):
        want = tell.ell_spmm_plain(plan, torch.from_numpy(h)).numpy()
        listed = tell.with_order(plan, order)
        np.testing.assert_allclose(kernel_restated(listed, h), want, rtol=RTOL, atol=ATOL)
        # the items list real slots only: the pads are skipped
        assert int(listed.work_len.sum()) == plan.nnz < plan.slots
        # another order lists the same items, and changes no sum
        key = lambda p: sorted(zip(p.work_beg.tolist(), p.work_len.tolist(),  # noqa: E731
                                   p.work_dst.tolist()))
        assert key(listed) == key(plan)
        assert torch.equal(listed.split_ptr, plan.split_ptr)


def test_item_orders():
    """'longest' lists the items by falling length, 'blocks' by block of
    neighbouring output rows, longest first within; in both the items without
    slots are last (kernel 2 launches only the first ``n_nonempty`` when it
    accumulates)."""
    rng = np.random.default_rng(0)
    n = 3 * tell.ORDER_BLOCK_ROWS
    length = rng.integers(0, 40, n)
    length[5], length[n - 7] = 700, 300
    start = np.cumsum(length) - length
    rows = rng.permutation(n)
    lists = {o: tell.work_list(start, length, rows, torch.device("cpu"), o)
             for o in tell.ORDERS}
    n_items = n + 2 + 1
    for order, w in lists.items():
        ln = w.len.numpy()
        assert len(ln) == n_items and w.n_nonempty == int((ln > 0).sum())
        assert (ln[:w.n_nonempty] > 0).all() and (ln[w.n_nonempty:] == 0).all()
    full = lambda w: w.len.numpy()[:w.n_nonempty]  # noqa: E731
    assert (np.diff(full(lists["longest"])) <= 0).all()
    w = lists["blocks"]
    dst = w.dst.numpy()[:w.n_nonempty]
    row_of = np.where(dst >= 0, dst, 0)
    row_of[dst < 0] = np.repeat(w.split_rows.numpy(), np.diff(w.split_ptr.numpy()))[-dst[dst < 0] - 1]
    block = row_of // tell.ORDER_BLOCK_ROWS
    assert (np.diff(block) >= 0).all() and len(np.unique(block)) == 3
    for b in range(3):
        assert (np.diff(full(w)[block == b]) <= 0).all()
    with pytest.raises(ValueError, match="unknown item order"):
        tell.work_list(start, length, rows, torch.device("cpu"), "shortest")


@pytest.mark.parametrize("pattern,order", [("random", "longest"), ("banded", "blocks"),
                                           ("half", "blocks"), ("empty", "longest")])
def test_item_order_follows_the_graphs_locality(pattern, order):
    """``pick_order`` reads the share of edges within a block's width of the
    diagonal: a graph numbered at random keeps 'longest', one whose rows gather
    their neighbours in node order gets 'blocks'."""
    rng = np.random.default_rng(2)
    n, deg = 8 * tell.ORDER_BLOCK_ROWS, 4
    row = np.repeat(np.arange(n), deg)
    far = rng.integers(0, n, n * deg)
    near = np.clip(row + rng.integers(-64, 65, n * deg), 0, n - 1)
    cols = {"random": far, "banded": near, "empty": far[:0],
            "half": np.where(np.arange(n * deg) % 5 < 3, near, far)}[pattern]
    indptr = np.arange(n + 1) * (0 if pattern == "empty" else deg)
    assert tell.pick_order(indptr, cols) == order


def test_build_graph_lists_the_items_in_the_picked_order(graphs):
    """The test graphs are smaller than a block, so every edge is near: the
    plan says 'blocks', which within one block is longest first."""
    _, _, tg = graphs
    for plan in filter(None, (tg.ell, tg.ell_t)):
        assert plan.order == "blocks" and plan.n_nodes < tell.ORDER_BLOCK_ROWS
        longest = tell.with_order(plan, "longest")
        assert longest.order == "longest"
        for a, b in ((plan.work_beg, longest.work_beg), (plan.work_len, longest.work_len),
                     (plan.work_dst, longest.work_dst)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("d", [3, 6, 16, 41])
def test_ell_spmm_plain_matches_jax_pallas(graphs, d):
    _, jg, tg = graphs
    h = np.random.default_rng(d).standard_normal((tg.n_nodes, d)).astype(np.float32)
    want = np.asarray(pallas_spmm.ell_spmm(jnp.asarray(h), jg.ell_fwd, jg.n_nodes))
    got = tell.ell_spmm(tg.ell, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["ell", "pallas"])
def test_graphsum_and_gradient_match_jax(graphs, backend):
    csr, _, _ = graphs
    jg = jgraph.build_graph(csr, backend=backend)
    tg = tgraph.build_graph(tds.CSR(np.asarray(csr.indptr), np.asarray(csr.indices)),
                            backend=backend, device="cpu")
    rng = np.random.default_rng(1)
    h = rng.standard_normal((tg.n_nodes, 6)).astype(np.float32)
    cot = rng.standard_normal((tg.n_nodes, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jgraphsum(x, jg), jnp.asarray(h))
    (want_grad,) = vjp(jnp.asarray(cot))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tgs.graphsum(th, tg)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


def test_train_run_pallas_matches_jax(tiny_dataset):
    """The slice as a whole: train.run on the pallas backend, dropout 0, from
    the JAX package's weights (convert.py)."""
    from test_torch_train import to_torch_dataset

    cfg = JConfig(epochs=3, dropout=0.0, graphsum_backend="pallas", seed=0)
    want = jtrain.run(cfg, tiny_dataset, verbose=False)
    jstate = jtrain.create_state(tiny_dataset.apply_config(cfg))
    tcfg = GCNConfig(epochs=3, dropout=0.0, graphsum_backend="pallas", seed=0)
    tdata = to_torch_dataset(tiny_dataset)
    state = ttrain.create_state(tdata.apply_config(tcfg), "cpu")
    state.model.load_state_dict(convert.params_from_jax(
        {k: np.asarray(v) for k, v in jstate.params.items()}, "cpu"))
    got = ttrain.run(tcfg, tdata, device="cpu", verbose=False, initial_state=state)
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    np.testing.assert_allclose([[h[k] for k in keys] for h in got.history],
                               [[h[k] for k in keys] for h in want.history],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose([got.test_loss, got.test_acc],
                               [want.test_loss, want.test_acc], rtol=1e-4, atol=1e-4)
    for k, p in got.state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want.state.params[k]),
                                   rtol=1e-4, atol=1e-5)
