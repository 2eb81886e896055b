"""The port's sparse layer-0 product against the JAX package's ``csr_matmul``.

The same CSR feature matrix, weights and cotangent (numpy, from a seed) go
through ``cuda_gcn_tpu.ops.matmul.csr_matmul`` with ``jax.vjp`` and through the
port's ``csr_matmul`` (on the CPU: its plain version under autograd) and
``csr_matmul_dw`` (the transposed product the kernels compute on the card, here
through its plain version). Tolerance rtol 1e-5, atol 1e-6: f32 sums of a few
products whose order differs. The CSR of Xᵀ and ``t_perm`` are held exactly
against ``scipy.sparse``. The forward's work list over X's rows, which kernel
2 walks on the card, is restated in numpy and held against the JAX product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cuda_gcn_tpu.ops import matmul as jmm

from cuda_gcn_torch.ops import matmul as tmm

TOL = dict(rtol=1e-5, atol=1e-6)


def random_csr(n_rows, n_cols, density, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density, format="csr", dtype=np.float32,
                  random_state=rng)
    m.data[:] = rng.standard_normal(len(m.data)).astype(np.float32)
    m = m.tolil()
    for r in empty_rows:
        m.rows[r], m.data[r] = [], []
    m = m.tocsr()
    m.sort_indices()
    return m


CASES = {"wide": (40, 90, 0.1, ()), "tall": (120, 7, 0.3, (0, 5, 119)),
         "square": (64, 64, 0.05, (3,)), "empty": (12, 9, 0.0, ())}


@pytest.fixture(params=list(CASES))
def problem(request):
    n_rows, n_cols, density, empty_rows = CASES[request.param]
    m = random_csr(n_rows, n_cols, density, seed=n_rows, empty_rows=empty_rows)
    rng = np.random.default_rng(n_cols)
    w = rng.standard_normal((n_cols, 5)).astype(np.float32)
    g = rng.standard_normal((n_rows, 5)).astype(np.float32)
    x = tmm.SparseFeatures.from_csr(m.indptr, m.indices, m.data, n_cols, "cpu")
    return m, x, w, g


def test_forward_and_both_gradients_match_jax(problem):
    m, x, w, g = problem
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(m.indptr))
    want, vjp = jax.vjp(
        lambda v, ww: jmm.csr_matmul(v, jnp.asarray(rows), jnp.asarray(m.indices), ww,
                                     m.shape[0]),
        jnp.asarray(m.data), jnp.asarray(w))
    want_dv, want_dw = vjp(jnp.asarray(g))
    values = x.values.clone().requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = tmm.csr_matmul(values, x, tw)
    assert out.shape == (m.shape[0], 5) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), m @ w, **TOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **TOL)
    np.testing.assert_allclose(values.grad.numpy(), np.asarray(want_dv), **TOL)
    # the transposed product that runs on the card, and the autograd Function's
    # formula for the values' gradient
    dw = tmm.csr_matmul_dw(x, x.values, torch.from_numpy(g))
    assert dw.shape == (m.shape[1], 5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **TOL)
    dv = (torch.from_numpy(w)[x.cols.long()] * torch.from_numpy(g)[x.rows.long()]).sum(1)
    np.testing.assert_allclose(dv.numpy(), np.asarray(want_dv), **TOL)


def test_transpose_structures_match_scipy(problem):
    m, x, _, _ = problem
    assert (x.n_rows, x.n_cols, x.nnz) == (*m.shape, m.nnz)
    np.testing.assert_array_equal(x.row_ptr.numpy(), m.indptr)
    np.testing.assert_array_equal(x.cols.numpy(), m.indices)
    np.testing.assert_array_equal(
        x.rows.numpy(), np.repeat(np.arange(m.shape[0]), np.diff(m.indptr)))
    t = m.T.tocsr()
    t.sort_indices()
    np.testing.assert_array_equal(x.t_ptr.numpy(), t.indptr)
    np.testing.assert_array_equal(x.t_rows.numpy(), t.indices)
    np.testing.assert_array_equal(x.values[x.t_perm].numpy(), t.data)
    assert x.t_perm.dtype == torch.int64 and x.t_ptr.dtype == x.t_rows.dtype == torch.int32
    # the work list writes every row of dW exactly once, empty ones included
    whole = x.t_work.dst[x.t_work.dst >= 0].numpy()
    split = x.t_work.split_rows.numpy()
    assert sorted([*whole, *split]) == list(range(m.shape[1]))


def test_forward_work_list_matches_jax(problem):
    """``from_csr`` carries kernel 2's work list over the rows of X: every row
    of the product has one writer (an empty row's item writes zeros), and the
    items' sums equal the JAX sparse product and the port's ``csr_matmul``."""
    m, x, w, _ = problem
    work = x.work
    n_items = len(work.beg)
    assert work.n_nonempty == int((np.diff(m.indptr) > 0).sum()) <= n_items
    assert int(work.len.sum()) == m.nnz and work.n_partials == 0
    cols, values = x.cols.numpy(), x.values.numpy()
    got = np.full((m.shape[0], w.shape[1]), np.nan, np.float32)
    for beg, ln, dst in zip(work.beg.tolist(), work.len.tolist(), work.dst.tolist()):
        assert np.isnan(got[dst]).all()  # one writer
        got[dst] = (values[beg:beg + ln, None] * w[cols[beg:beg + ln]]).sum(0)
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(m.indptr))
    want = np.asarray(jmm.csr_matmul(jnp.asarray(m.data), jnp.asarray(rows),
                                     jnp.asarray(m.indices), jnp.asarray(w), m.shape[0]))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(tmm.csr_matmul(x.values, x, torch.from_numpy(w)).numpy(), want,
                               **TOL)


def test_dw_work_list_chunks_long_columns():
    """A column of more entries than a work item takes is cut into chunks, in
    order (the layer-0 shape: few, long rows of Xᵀ)."""
    from cuda_gcn_torch.ops.ell import ELL_CHUNK_SLOTS

    n = 3 * ELL_CHUNK_SLOTS + 10
    indptr = np.arange(n + 1)
    indices = np.zeros(n, np.int64)  # every row has its one entry in column 0 of 2
    x = tmm.SparseFeatures.from_csr(indptr, indices, np.ones(n, np.float32), 2, "cpu")
    t = x.t_work
    assert t.n_partials == 4 and t.split_rows.tolist() == [0] and t.split_ptr.tolist() == [0, 4]
    assert sorted(t.len.tolist()) == [0, 10, *[ELL_CHUNK_SLOTS] * 3]
    g = torch.arange(n, dtype=torch.float32)[:, None]
    np.testing.assert_array_equal(tmm.csr_matmul_dw(x, x.values, g).numpy(),
                                  [[n * (n - 1) / 2], [0.0]])


def test_dropped_values_reach_the_transpose():
    """``csr_matmul_dw`` permutes the values it is given, so a dropout on the
    forward's values is the dropout of the backward's."""
    m = random_csr(30, 20, 0.2, seed=2)
    x = tmm.SparseFeatures.from_csr(m.indptr, m.indices, m.data, 20, "cpu")
    keep = torch.from_numpy(np.random.default_rng(0).random(m.nnz) < 0.5)
    dropped = torch.where(keep, x.values * 2, torch.zeros(()))
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((30, 4)).astype(np.float32))
    md = m.copy()
    md.data = dropped.numpy()
    np.testing.assert_allclose(tmm.csr_matmul_dw(x, dropped, g).numpy(), md.T @ g.numpy(),
                               **TOL)


def test_feature_ids_outside_the_matrix_raise():
    with pytest.raises(ValueError, match="feature ids"):
        tmm.SparseFeatures.from_csr(np.array([0, 1]), np.array([4]), np.ones(1, np.float32),
                                    4, "cpu")
    # the JAX package bands its features from this many rows on; the port keeps
    # the CSR layout at every size and has no such threshold
    assert jmm.BANDED_FEATURES_MIN_ROWS == 1 << 19
    assert not hasattr(tmm, "BANDED_FEATURES_MIN_ROWS")
