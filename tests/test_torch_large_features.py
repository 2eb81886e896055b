"""Sparse layer-0 features past the JAX package's band threshold.

From ``BANDED_FEATURES_MIN_ROWS`` (2^19) rows on, the JAX package lays the
feature CSR out in row bands (``BandedFeatures``, ``banded_matmul``); the port
keeps its CSR product at every size. Both must give the same result on the
same input: the JAX threshold is lowered to one row and its band to 16 rows on
``tiny_dataset``, as tests/test_model.py:126-157 does, and a ring graph of
2^19 nodes crosses the real threshold. Tolerances: the product and its dW
within rtol 1e-5 / atol 1e-6, three fused epochs at dropout 0 within rtol
1e-4 / atol 1e-5 (the JAX package's own, tests/test_model.py); at bf16, those
of tests/test_torch_bf16.py. Dropout masks differ by construction (JAX draws
over the [B, Emax] band array, the port over the nnz), so at dropout 0.5 the
port's run must only train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.data.parser import CSR as JCSR
from cuda_gcn_tpu.data.parser import GCNDataset as JDataset
from cuda_gcn_tpu.ops import matmul as jmm

from cuda_gcn_torch import convert
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.ops import matmul as tmm
from test_torch_bf16 import GRAD_TOL, GS_TOL, LOSS_RTOL, _to_np
from test_torch_train import to_torch_dataset

PRODUCT_TOL = dict(rtol=1e-5, atol=1e-6)
EPOCH_TOL = dict(rtol=1e-4, atol=1e-5)
# (compute_dtype, param_dtype)
DTYPES = [("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


@pytest.fixture
def small_bands(monkeypatch):
    monkeypatch.setattr(jmm, "BANDED_FEATURES_MIN_ROWS", 1)
    monkeypatch.setattr(jmm, "FEAT_BAND_ROWS", 16)


def _prepared(ds, compute_dtype, param_dtype, **kw):
    """The JAX package's banded inputs and state, and the port's sparse inputs
    and state at the JAX weights."""
    args = dict(feature_matmul="sparse", dropout=0.0, epochs=3, seed=0,
                compute_dtype=compute_dtype, param_dtype=param_dtype, **kw)
    jcfg, jg, jx, jtruths = jtrain.prepare(JConfig(**args), ds)
    assert isinstance(jx, jmm.BandedFeatures)
    tcfg, tg, tx, ttruths = ttrain.prepare(GCNConfig(**args), to_torch_dataset(ds), "cpu")
    assert isinstance(tx, tmm.SparseFeatures) and tx.n_rows == ds.num_nodes
    jstate = jtrain.create_state(jcfg)
    state = ttrain.create_state(tcfg, "cpu")
    state.model.load_state_dict(convert.params_from_jax(
        {k: np.asarray(v) for k, v in jstate.params.items()}, "cpu"))
    return (jcfg, jg, jx, jtruths, jstate), (tcfg, tg, tx, ttruths, state)


def _epochs(jprep, tprep, epochs, dropout=0.0):
    jcfg, jg, jx, jtruths, jstate = jprep
    tcfg, tg, tx, ttruths, state = tprep
    kw = dict(dropout_rate=dropout, weight_decay=jcfg.weight_decay, lr=jcfg.learning_rate)
    jstate, jm = jtrain.run_epochs(jstate, jg, jx, jtruths[1], jtruths[2], epochs=epochs, **kw)
    got = ttrain.run_epochs(state, tg, tx, ttruths[1], ttruths[2], epochs=epochs, **kw)
    return got.numpy(), np.stack([np.asarray(m) for m in jm], axis=1), jstate


@pytest.mark.parametrize("compute_dtype,param_dtype", DTYPES)
def test_csr_product_equals_the_banded_product(tiny_dataset, small_bands, compute_dtype,
                                               param_dtype):
    """X·W and dW = Xᵀ·g of the port's CSR product against ``banded_matmul``
    and its VJP, on the same features, weights and cotangent."""
    jprep, tprep = _prepared(tiny_dataset, compute_dtype, param_dtype)
    jx, tx = jprep[2], tprep[2]
    assert jx.vals.shape[0] > 1  # several bands
    rng = np.random.default_rng(5)
    w32 = rng.standard_normal((tiny_dataset.input_dim, 5)).astype(np.float32)
    g32 = rng.standard_normal((tiny_dataset.num_nodes, 5)).astype(np.float32)
    jw = jnp.asarray(w32).astype(jnp.dtype(param_dtype))
    jgrad = jnp.asarray(g32).astype(jnp.dtype(param_dtype))
    want, vjp = jax.vjp(lambda ww: jmm.banded_matmul(ww, jx.vals, jx), jw)
    want_dw = vjp(jgrad)[0]
    tw = convert.tensor_from_jax(np.asarray(jw), "cpu")
    tg = convert.tensor_from_jax(np.asarray(jgrad), "cpu")
    got = tmm.csr_matmul(tx.values, tx, tw)
    got_dw = tmm.csr_matmul_dw(tx, tx.values.to(tw.dtype), tg)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    fw_tol, dw_tol = (PRODUCT_TOL, PRODUCT_TOL) if compute_dtype == "float32" \
        else (GS_TOL, GRAD_TOL)
    np.testing.assert_allclose(got.float().numpy(), _to_np(want), **fw_tol)
    np.testing.assert_allclose(got_dw.float().numpy(), _to_np(want_dw), **dw_tol)


@pytest.mark.parametrize("compute_dtype,param_dtype", DTYPES)
def test_sparse_run_equals_the_banded_run(tiny_dataset, small_bands, compute_dtype,
                                          param_dtype):
    """Eval logits and three fused epochs at dropout 0 from the same weights;
    at dropout 0.5 the port's run trains."""
    jprep, tprep = _prepared(tiny_dataset, compute_dtype, param_dtype)
    from cuda_gcn_tpu.models import gcn as jgcn

    want_logits = jgcn.apply(jprep[4].params, jprep[1], jprep[2], training=False)
    with torch.no_grad():
        got_logits = tprep[4].model(tprep[1], tprep[2])
    got, want, _ = _epochs(jprep, tprep, 3)
    if compute_dtype == "float32":
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **PRODUCT_TOL)
        np.testing.assert_allclose(got, want, **EPOCH_TOL)
    else:
        np.testing.assert_allclose(got_logits.float().numpy(), _to_np(want_logits), **GS_TOL)
        np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=LOSS_RTOL)
        one_node = [1.5 / int((np.asarray(jprep[3][s]) >= 0).sum()) for s in (1, 2)]
        assert (np.abs(got[:, [1, 3]] - want[:, [1, 3]]) <= one_node).all()
    tcfg, tg, tx, ttruths, _ = tprep
    state = ttrain.create_state(tcfg, "cpu")
    m = ttrain.run_epochs(state, tg, tx, ttruths[1], ttruths[2], epochs=8, dropout_rate=0.5,
                          weight_decay=tcfg.weight_decay, lr=0.05).numpy()
    assert np.isfinite(m).all() and m[-1, 0] < m[0, 0]


def _ring(n: int, n_feat: int = 8, n_classes: int = 3, seed: int = 0) -> JDataset:
    """A ring of ``n`` nodes (self-loop first, then both neighbours), one
    feature nnz a row, labels by node id modulo the classes, random splits."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    cols = np.stack([i, (i - 1) % n, (i + 1) % n], 1).astype(np.int32).reshape(-1)
    return JDataset(
        graph=JCSR(np.arange(0, 3 * n + 1, 3, dtype=np.int32), cols),
        feature_index=JCSR(np.arange(n + 1, dtype=np.int32),
                           rng.integers(0, n_feat, n).astype(np.int32)),
        feature_value=(rng.random(n) + 0.5).astype(np.float32),
        label=(i % n_classes).astype(np.int32), split=rng.integers(1, 4, n).astype(np.int32),
        num_nodes=n, input_dim=n_feat, output_dim=n_classes)


def test_sparse_features_at_the_real_threshold():
    """2^19 nodes, nothing monkeypatched: the JAX package takes its bands, the
    port its CSR product (``prepare`` no longer refuses the graph), and one
    epoch at dropout 0 agrees."""
    ds = _ring(1 << 19)
    assert ds.num_nodes == jmm.BANDED_FEATURES_MIN_ROWS
    jprep, tprep = _prepared(ds, "float32", "float32", hidden_dim=4,
                             graphsum_backend="segment")
    got, want, jstate = _epochs(jprep, tprep, 1)
    np.testing.assert_allclose(got, want, **EPOCH_TOL)
    for k, p in tprep[4].model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                   **EPOCH_TOL)
