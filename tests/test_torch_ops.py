"""The port's operators against the JAX package's, on the CPU.

Kernel 1's and kernel 2's plain versions (the code the wrappers run for CPU
tensors) against the XLA and interpret-mode Pallas paths; graphsum forward and
backward against ``jax.vjp``; loss, accuracy, L2 and Adam at 1e-6; dropout by
distribution. Tolerances: rtol 1e-5 / atol 1e-6 in f32 wherever only the
summation order differs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu.data import graph as jgraph
from cuda_gcn_tpu.data.reorder import locality_permutation
from cuda_gcn_tpu.data.reorder import reorder_dataset as j_reorder
from cuda_gcn_tpu.data.synthetic import SynthSpec, make_synthetic
from cuda_gcn_tpu.ops import adam as jadam
from cuda_gcn_tpu.ops import loss as jloss
from cuda_gcn_tpu.ops import pallas_bsr

from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import graph as tgraph
from cuda_gcn_torch.ops import adam as tadam
from cuda_gcn_torch.ops import bsr as tbsr
from cuda_gcn_torch.ops import dropout as tdropout
from cuda_gcn_torch.ops import graphsum as tgs
from cuda_gcn_torch.ops import loss as tloss
from cuda_gcn_torch.ops import residual as tres

# the package re-exports the graphsum function under the module's name
jgs = importlib.import_module("cuda_gcn_tpu.ops.graphsum")

RTOL, ATOL = 1e-5, 1e-6
WIDTHS = [16, 32, 41, 82]  # the main path's pass widths


@pytest.fixture(scope="module")
def clustered():
    spec = SynthSpec(num_nodes=256, num_edges=4000, num_classes=4, input_dim=16,
                     nnz_per_node=4, homophily=0.9, train_per_class=10,
                     num_val=40, num_test=60)
    ds = make_synthetic(spec, seed=11)
    return j_reorder(ds, locality_permutation(ds.graph)).dataset


def tcsr(csr):
    return tds.CSR(np.asarray(csr.indptr), np.asarray(csr.indices))


def random_tiles(transpose, dtype=np.float32):
    """7 tiles over 6 block rows of 32: a 3-tile run, empty block rows, the
    first and last rows, and n short of T*tb. Output rows are sorted for the
    forward orientation and shuffled for the transpose one. Values are scaled
    like rows of Â (nonnegative, each tile row summing to about 1/2)."""
    rng = np.random.default_rng(3)
    tb, t_blocks = 32, 6
    n = t_blocks * tb - 13
    rows = np.array([0, 0, 1, 3, 3, 3, 5], np.int32)
    cols = np.array([5, 0, 1, 2, 0, 4, 3], np.int32)
    if transpose:
        rows = rng.permutation(rows).astype(np.int32)
    tiles = (rng.random((7, tb, tb)) / tb).astype(dtype)
    return tiles, rows, cols, n, t_blocks


def jax_dense_part(tiles, rows, cols, h, n, t_blocks, transpose):
    """graphsum._dense_tile_part's XLA path (round trip through [d, T, tb])."""
    tb, d = tiles.shape[1], h.shape[1]
    hT = jnp.pad(jnp.asarray(h), ((0, t_blocks * tb - n), (0, 0))).T.reshape(d, t_blocks, tb)
    outb = jgs._tile_contract(jnp.asarray(tiles), jnp.asarray(rows), jnp.asarray(cols),
                              hT, t_blocks, transpose)
    return np.asarray(outb.transpose(1, 0, 2).reshape(d, t_blocks * tb)[:, :n].T)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("d", WIDTHS)
def test_tile_contract_plain_matches_xla(d, transpose):
    tiles, rows, cols, n, t_blocks = random_tiles(transpose)
    h = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    want = jax_dense_part(tiles, rows, cols, h, n, t_blocks, transpose)
    got = tbsr.bsr_tile_contract(torch.from_numpy(tiles), torch.from_numpy(rows),
                                 torch.from_numpy(cols), torch.from_numpy(h), n,
                                 t_blocks, transpose=transpose)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    empty = sorted(set(range(t_blocks)) - set(rows.tolist()))
    for r in empty:  # block rows no tile visits are exactly zero
        assert not got[r * 32:(r + 1) * 32].any()


@pytest.mark.parametrize("variant", ["blocked", "resident"])
@pytest.mark.parametrize("d", WIDTHS)
def test_tile_contract_plain_matches_pallas(d, variant):
    """Against both TPU kernels in interpret mode, with bf16 tiles (the
    production storage) upcast in both."""
    import ml_dtypes

    tiles, rows, cols, n, t_blocks = random_tiles(False)
    tiles_bf16 = tiles.astype(ml_dtypes.bfloat16)
    h = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    want = np.asarray(pallas_bsr.bsr_tile_contract(
        jnp.asarray(tiles_bf16), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(h),
        n, t_blocks, interpret=True, variant=variant))
    t_tiles = torch.from_numpy(tiles_bf16.view(np.int16)).view(torch.bfloat16)
    got = tbsr.bsr_tile_contract(t_tiles, torch.from_numpy(rows),
                                 torch.from_numpy(cols), torch.from_numpy(h), n, t_blocks)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_tile_plan_groups_by_output_row():
    tiles, rows, cols, n, t_blocks = random_tiles(True)
    plan = tbsr.tile_plan(torch.from_numpy(rows), torch.from_numpy(cols), t_blocks)
    ptr, order = plan.ptr.numpy(), plan.order.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(rows)
    for r in range(t_blocks):
        slots = order[ptr[r]:ptr[r + 1]]
        assert (rows[slots] == r).all()
        np.testing.assert_array_equal(slots, np.sort(slots))  # stable
    np.testing.assert_array_equal(plan.hblk.numpy(), cols[order])


@pytest.mark.parametrize("d", WIDTHS)
def test_residual_plain_matches_segment_apply(clustered, d):
    g = tgraph.build_graph(tcsr(clustered.graph), backend="segment", device="cpu")
    jg = jgraph.build_graph(clustered.graph, backend="segment")
    rng = np.random.default_rng(d)
    h = rng.standard_normal((g.n_nodes, d)).astype(np.float32)
    want = np.asarray(jgs._segment_apply(jnp.asarray(h), jg.src, jg.dst, jg.coef,
                                         g.n_nodes))
    r = g.resid
    got = tres.residual_spmm(r.row_ptr, r.cols, r.coef, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    base = rng.standard_normal((g.n_nodes, d)).astype(np.float32)
    out = torch.from_numpy(base.copy())
    got2 = tres.residual_spmm(r.row_ptr, r.cols, r.coef, torch.from_numpy(h), out=out)
    assert got2 is out
    np.testing.assert_allclose(got2.numpy(), base + want, rtol=RTOL, atol=ATOL)


def graph_pair(csr, backend, **kw):
    return (jgraph.build_graph(csr, backend=backend, **kw),
            tgraph.build_graph(tcsr(csr), backend=backend, device="cpu", **kw))


def asymmetric_csr():
    from cuda_gcn_tpu.data.parser import CSR

    rng = np.random.default_rng(7)
    rows = [np.sort(np.unique(np.append(rng.integers(0, 96, rng.integers(1, 6)), i)))
            for i in range(96)]
    indptr = np.zeros(97, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    return CSR(indptr, np.concatenate(rows).astype(np.int64))


BSR32 = dict(bsr_tile=32, bsr_min_edges=8)


@pytest.mark.parametrize("case", ["bsr-f32", "bsr-bf16", "segment", "dense",
                                  "bsr-asymmetric", "segment-asymmetric"])
def test_graphsum_forward_and_vjp_match_jax(clustered, case):
    if case.endswith("asymmetric"):
        csr, backend = asymmetric_csr(), case.split("-")[0]
        kw = dict(bsr_tile=32, bsr_min_edges=2, bsr_dtype="float32") if backend == "bsr" else {}
    else:
        csr, backend = clustered.graph, case.split("-")[0]
        kw = dict(BSR32, bsr_dtype="bfloat16" if case == "bsr-bf16" else "float32") \
            if backend == "bsr" else {}
    jg, tg = graph_pair(csr, backend, **kw)
    assert tg.symmetric == (not case.endswith("asymmetric"))
    if backend == "bsr":
        assert tg.num_tiles > 0
    rng = np.random.default_rng(1)
    n = tg.n_nodes
    h = rng.standard_normal((n, 41)).astype(np.float32)
    g = rng.standard_normal((n, 41)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jgs.graphsum(x, jg), jnp.asarray(h))
    (want_dh,) = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_(True)
    got = tgs.graphsum(th, tg)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), rtol=RTOL, atol=ATOL)


def test_graphsum_pair_matches_jax(clustered):
    jg, tg = graph_pair(clustered.graph, "bsr", **BSR32, bsr_dtype="float32")
    rng = np.random.default_rng(2)
    n = tg.n_nodes
    zt, ze = (rng.standard_normal((n, w)).astype(np.float32) for w in (16, 16))
    g = rng.standard_normal((n, 16)).astype(np.float32)

    def f(a, b):
        out_t, out_e = jgs.graphsum_pair(a, b, jg)
        return out_t, out_e

    (want_t, want_e), vjp = jax.vjp(f, jnp.asarray(zt), jnp.asarray(ze))
    want_dzt, want_dze = vjp((jnp.asarray(g), jnp.ones_like(want_e)))
    tzt = torch.from_numpy(zt).requires_grad_(True)
    tze = torch.from_numpy(ze).requires_grad_(True)
    got_t, got_e = tgs.graphsum_pair(tzt, tze, tg)
    assert not got_e.requires_grad
    got_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tzt.grad.numpy(), np.asarray(want_dzt), rtol=RTOL, atol=ATOL)
    assert tze.grad is None and not np.asarray(want_dze).any()


def test_loss_accuracy_l2_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((50, 7)).astype(np.float32)
    logits[3, 2] = logits[3, 5] = logits[3].max() + 1.0  # a tie counts as correct
    truth = rng.integers(-1, 7, 50).astype(np.int32)
    truth[3] = 5
    w1 = rng.standard_normal((20, 16)).astype(np.float32)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(truth.astype(np.int64))
    for got, want in (
            (tloss.masked_cross_entropy(tl, tt), jloss.masked_cross_entropy(logits, truth)),
            (tloss.strict_accuracy(tl, tt), jloss.strict_accuracy(logits, truth)),
            (tloss.l2_penalty(torch.from_numpy(w1), 5e-4), jloss.l2_penalty(w1, 5e-4))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    # the CE gradient too
    tlg = tl.clone().requires_grad_(True)
    tloss.masked_cross_entropy(tlg, tt).backward()
    want_g = jax.grad(jloss.masked_cross_entropy)(jnp.asarray(logits), jnp.asarray(truth))
    np.testing.assert_allclose(tlg.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-7)


def test_adam_steps_match_jax():
    rng = np.random.default_rng(5)
    params = {"w1": rng.standard_normal((20, 16)).astype(np.float32),
              "w2": rng.standard_normal((16, 7)).astype(np.float32)}
    jp, js = {k: jnp.asarray(v) for k, v in params.items()}, None
    js = jadam.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = tadam.init(tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        jp, js = jadam.apply(jp, {k: jnp.asarray(v) for k, v in grads.items()}, js,
                             jadam.AdamParams(lr=0.01))
        tadam.step(tp, {k: torch.from_numpy(v) for k, v in grads.items()}, ts,
                   tadam.AdamParams(lr=0.01))
    assert int(ts.step) == int(js.step) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]), rtol=1e-6, atol=1e-6)


def test_dropout_distribution():
    """torch cannot reproduce threefry, so dropout is held to its
    distribution: keep rate 1-p, kept values scaled by 1/(1-p)."""
    x = torch.ones(400, 500)
    gen = torch.Generator().manual_seed(0)
    y = tdropout.dropout(x, 0.5, gen, training=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    assert torch.all(y[kept] == 2.0)
    y2 = tdropout.dropout(x, 0.5, gen, training=True)
    assert not torch.equal(y, y2)  # the generator advances
    assert tdropout.dropout(x, 0.5, gen, training=False) is x
    assert tdropout.dropout(x, 0.0, gen, training=True) is x
    # the same seed gives the same mask
    a = tdropout.dropout(x, 0.3, torch.Generator().manual_seed(9), training=True)
    b = tdropout.dropout(x, 0.3, torch.Generator().manual_seed(9), training=True)
    assert torch.equal(a, b)
