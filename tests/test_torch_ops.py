"""The port's operators against the JAX package's, on the CPU.

Kernel 1's and kernel 2's plain versions (the code the wrappers run for CPU
tensors) against the XLA and interpret-mode Pallas paths; graphsum forward and
backward against ``jax.vjp``; loss, accuracy, L2 and Adam at 1e-6; dropout by
distribution. Tolerances: rtol 1e-5 / atol 1e-6 in f32 wherever only the
summation order differs. Kernel 1's tensor-core arithmetic (h as three bf16
parts) and kernel 2's work list are restated here, in PyTorch and numpy, and
held against the plain versions and the JAX package.
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
from cuda_gcn_torch.ops import ell as tell
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


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16x3_sums_back_bit_for_bit(seed):
    """hi + mid + lo == h exactly, over 30 binades around 1 and down to 2^-110.
    Below that the last mantissa bits of h lie under bf16's smallest subnormal
    (2^-133 = 2^-110 / 2^23) and ``lo`` cannot hold them: exactness ends there."""
    rng = np.random.default_rng(seed)
    mant = rng.uniform(1.0, 2.0, 60000) * rng.choice([-1.0, 1.0], 60000)
    for lo_exp, hi_exp in ((-15, 15), (-110, -80)):
        h = (mant * np.exp2(rng.integers(lo_exp, hi_exp, mant.size))).astype(np.float32)
        parts = tbsr.split_bf16x3(torch.from_numpy(h))
        assert all(p.dtype == torch.bfloat16 for p in parts)
        hi, mid, lo = (p.float().numpy() for p in parts)
        np.testing.assert_array_equal((hi + mid) + lo, h)
        assert mid.any() and lo.any()
        # each part takes the remainder's leading bits: |mid| <= ulp(hi) / 2 and so on
        assert (np.abs(mid) <= np.abs(hi) * 2.0 ** -8).all()
        assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -16).all()
    tiny = (mant * 2.0 ** -120).astype(np.float32)  # last bits under 2^-133: not exact
    hi, mid, lo = (p.float().numpy() for p in tbsr.split_bf16x3(torch.from_numpy(tiny)))
    back = (hi + mid) + lo
    assert (back != tiny).any()
    np.testing.assert_allclose(back, tiny, rtol=0, atol=2.0 ** -133)


def _bf16(tiles):
    import ml_dtypes

    tiles_bf16 = tiles.astype(ml_dtypes.bfloat16)
    return tiles_bf16, torch.from_numpy(tiles_bf16.view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("d", [16, 41, 82])
def test_tile_contract_split_plain_matches_plain_and_jax(d, transpose):
    """The tensor-core kernel's arithmetic (three bf16 parts of h against bf16
    tiles, f32 sums) against the plain version and the JAX package: the Pallas
    kernel in interpret mode for the forward orientation, the XLA path for the
    transpose, which the JAX package has no Pallas kernel for. The three parts
    sum to h exactly and every product is exact in f32, so only the order and
    grouping of the f32 additions differ: tolerance 1e-6 · Σ|a·h|, about 8 f32
    epsilons of the sum of the terms' magnitudes."""
    tiles, rows, cols, n, t_blocks = random_tiles(transpose)
    tiles_bf16, t_tiles = _bf16(tiles)
    h = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    args = (t_tiles, torch.from_numpy(rows), torch.from_numpy(cols))
    got = tbsr.bsr_tile_contract_split_plain(*args, torch.from_numpy(h), n, t_blocks,
                                             transpose=transpose).numpy()
    plain = tbsr.bsr_tile_contract_plain(*args, torch.from_numpy(h), n, t_blocks,
                                         transpose=transpose).numpy()
    tol = 1e-6 * tbsr.bsr_tile_contract_plain(*args, torch.from_numpy(np.abs(h)), n, t_blocks,
                                              transpose=transpose).numpy()
    if transpose:
        want = jax_dense_part(tiles_bf16.astype(np.float32), rows, cols, h, n, t_blocks, True)
    else:
        want = np.asarray(pallas_bsr.bsr_tile_contract(
            jnp.asarray(tiles_bf16), jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(h),
            n, t_blocks, interpret=True))
    assert tol.max() > 0
    assert (np.abs(got - plain) <= tol).all()
    assert (np.abs(got - want) <= tol).all()
    for r in sorted(set(range(t_blocks)) - set(rows.tolist())):
        assert not got[r * 32:(r + 1) * 32].any()


def test_tile_plan_orders_block_rows_by_load():
    """``by_load`` lists every block row once, most tiles first, ties in row order."""
    _, rows, cols, _, t_blocks = random_tiles(False)
    plan = tbsr.tile_plan(torch.from_numpy(rows), torch.from_numpy(cols), t_blocks)
    assert plan.by_load.dtype == torch.int32
    assert plan.by_load.tolist() == [3, 0, 1, 5, 2, 4]  # 3, 2, 1, 1, 0, 0 tiles


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


def ragged_residual():
    """A residual CSR of 700 rows with about 3 edges per row, three rows of no
    edge (the first, one inside, the last) and two rows above the 256 edges of a
    work item (600 and 257)."""
    rng = np.random.default_rng(8)
    n = 700
    deg = rng.integers(1, 6, n)
    deg[[0, 310, n - 1]] = 0
    deg[5], deg[400] = 600, tell.ELL_CHUNK_SLOTS + 1
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([np.sort(rng.choice(n, k, replace=False)) for k in deg])
    coef = rng.standard_normal(len(rows)).astype(np.float32)
    return tgraph._residual_csr(rows, cols, coef, n, "cpu"), rows, cols, coef, deg


def residual_kernel_restated(r, h, base=None):
    """csrc/csr_spmm.cu in numpy: each work item sums its edges into its output
    row (added to the row's old value when accumulating) or into its partial;
    each chunked row adds its partials in chunk order (onto the old value when
    accumulating). Accumulating launches only the items that have edges.
    Returns the result and how often each output row was written."""
    w = r.work
    cols, coef = r.cols.numpy(), r.coef.numpy()
    n, d = len(r.row_ptr) - 1, h.shape[1]
    accumulate = base is not None
    out = base.copy() if accumulate else np.full((n, d), np.nan, np.float32)
    partial = np.full((w.n_partials, d), np.nan, np.float32)
    writes = np.zeros(n, np.int64)
    n_items = w.n_nonempty if accumulate else len(w.beg)
    for beg, ln, dst in zip(w.beg.tolist()[:n_items], w.len.tolist()[:n_items],
                            w.dst.tolist()[:n_items]):
        assert 0 <= ln <= tell.ELL_CHUNK_SLOTS and (ln > 0 or not accumulate)
        s = (coef[beg:beg + ln, None] * h[cols[beg:beg + ln]]).sum(0, dtype=np.float32)
        if dst >= 0:
            out[dst] = out[dst] + s if accumulate else s
            writes[dst] += 1
        else:
            partial[-dst - 1] = s
    ptr = w.split_ptr.numpy()
    for i, row in enumerate(w.split_rows.tolist()):
        s = partial[ptr[i]:ptr[i + 1]].sum(0, dtype=np.float32)
        out[row] = out[row] + s if accumulate else s
        writes[row] += 1
    assert not np.isnan(partial).any()
    return out, writes


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("d", [16, 41])
def test_residual_work_list_restates_the_kernel(d, accumulate):
    r, rows, cols, coef, deg = ragged_residual()
    w = r.work
    assert w.n_nonempty == len(w.beg) - 3 and (w.len[w.n_nonempty:] == 0).all()
    assert w.split_rows.tolist() == [5, 400] and w.split_ptr.tolist() == [0, 3, 5]
    assert int(w.len.sum()) == r.nnz == len(rows)
    rng = np.random.default_rng(d)
    h = rng.standard_normal((len(deg), d)).astype(np.float32)
    base = rng.standard_normal((len(deg), d)).astype(np.float32) if accumulate else None
    got, writes = residual_kernel_restated(r, h, base)
    # one writer per output row; when accumulating, the empty rows are left alone
    np.testing.assert_array_equal(writes, (deg > 0).astype(int) if accumulate else 1)
    out = torch.from_numpy(base.copy()) if accumulate else None
    plain = tres.residual_spmm_plain(r.row_ptr, r.cols, r.coef, torch.from_numpy(h), out)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(jgs._segment_apply(jnp.asarray(h), jnp.asarray(rows), jnp.asarray(cols),
                                         jnp.asarray(coef), len(deg)))
    np.testing.assert_allclose(got, want + base if accumulate else want, rtol=1e-5, atol=1e-5)
    if not accumulate:
        assert not got[deg == 0].any()  # an empty row's item writes zeros


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
