"""The port at bf16 (``compute_dtype``, ``param_dtype``) against the JAX
package, on the CPU through the plain versions of the kernels.

The same graph, features and weights go through both packages, and every
activation must come out in the JAX package's type. Tolerances are the JAX
package's own for bf16: rtol and atol 2e-2 for a graphsum
(tests/test_bsr.py:46), rtol 5e-3 for a loss and rtol 0.05, atol 5e-4 for a
gradient (tests/test_parallel.py:580-583); an accuracy may differ by one node
of its split, where a bf16 rounding tips an argmax. The JAX package cannot
multiply bf16 tiles by bf16 h on the CPU (XLA's CPU dot has no bf16 x bf16 ->
f32), so its bsr graphs here store f32 tiles; the port's are checked with f32
tiles and with its default bf16 tiles against them.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.data import graph as jgraph
from cuda_gcn_tpu.data.parser import CSR as JCSR
from cuda_gcn_tpu.data.synthetic import SynthSpec, make_synthetic
from cuda_gcn_tpu.models import gcn as jgcn
from cuda_gcn_tpu.ops import adam as jadam

from cuda_gcn_torch import convert
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import graph as tgraph
from cuda_gcn_torch.ops import adam as tadam
from cuda_gcn_torch.ops import graphsum as tgs
from cuda_gcn_torch.ops.matmul import dense_matmul
from test_torch_train import to_torch_dataset

GS_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_RTOL = 5e-3
GRAD_TOL = dict(rtol=0.05, atol=5e-4)
BSR = dict(bsr_tile=32, bsr_min_edges=8, bsr_dtype="float32")
BF16 = torch.bfloat16
# the module (cuda_gcn_tpu.ops re-exports its function under the same name)
jgs = importlib.import_module("cuda_gcn_tpu.ops.graphsum")


@pytest.fixture(scope="module")
def clustered():
    """The community graph of tests/test_bsr.py, whose Â has dense tiles of 32."""
    spec = SynthSpec(num_nodes=256, num_edges=4000, num_classes=4, input_dim=16,
                     nnz_per_node=4, homophily=0.9, train_per_class=10, num_val=40,
                     num_test=60)
    return make_synthetic(spec, seed=11)


def _asymmetric(csr):
    """The CSR with every edge (i, j), i < j, i + j divisible by 3 dropped in
    one direction only (self-loops kept): Â ≠ Âᵀ, so the transpose runs on
    its own structures."""
    indptr, indices = np.asarray(csr.indptr), np.asarray(csr.indices)
    rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    keep = ~((rows < indices) & ((rows + indices) % 3 == 0))
    new_ptr = np.zeros_like(indptr)
    np.cumsum(np.bincount(rows[keep], minlength=len(indptr) - 1), out=new_ptr[1:])
    return new_ptr.astype(np.int32), indices[keep].astype(np.int32)


def _graphs(ds, backend, tiles, symmetric):
    indptr, indices = ((np.asarray(ds.graph.indptr), np.asarray(ds.graph.indices)) if symmetric
                       else _asymmetric(ds.graph))
    kw = BSR if backend == "bsr" else {}
    jg = jgraph.build_graph(JCSR(indptr, indices), backend=backend, act_itemsize=2, **kw)
    tkw = dict(kw, bsr_dtype=tiles) if backend == "bsr" else {}
    tg = tgraph.build_graph(tds.CSR(indptr, indices), backend=backend, act_itemsize=2,
                            device="cpu", **tkw)
    assert tg.symmetric == symmetric and (backend != "bsr" or tg.num_tiles > 0)
    return jg, tg


def _to_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
@pytest.mark.parametrize("backend,tiles", [
    ("dense", None), ("segment", None), ("bsr", "float32"), ("bsr", "bfloat16"),
    ("ell", None), ("pallas", None)])
def test_graphsum_at_bf16_matches_jax(clustered, backend, tiles, direction, symmetric):
    """Â·h and Âᵀ·g for bf16 h: bf16 out as in the JAX package, within its bf16
    tolerance; the graph's edge coefficients are stored in bf16."""
    jg, tg = _graphs(clustered, backend, tiles, symmetric)
    h = np.random.default_rng(1).standard_normal((clustered.num_nodes, 12)).astype(np.float32)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    th = torch.from_numpy(h).to(BF16)
    if direction == "forward":
        want, got = jgs._forward(jh, jg), tgs.forward(th, tg)
    else:
        want, got = jgs._transpose_forward(jh, jg), tgs.transpose_forward(th, tg)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), _to_np(want), **GS_TOL)
    coef = {"segment": tg.resid, "bsr": tg.resid}.get(backend)
    if coef is not None:
        assert coef.coef.dtype == BF16
    if backend in ("ell", "pallas"):
        assert tg.ell.coef.dtype == BF16


@pytest.mark.parametrize("backend", ["segment", "bsr", "ell"])
def test_f32_layer_on_a_graph_built_for_bf16(clustered, backend):
    """Sparse features at f32 weights give an f32 layer 0, whose graphsum runs
    at f32 over the bf16 coefficients (the kernels' (f32, bf16) variant)."""
    jg, tg = _graphs(clustered, backend, "bfloat16", True)
    h = np.random.default_rng(2).standard_normal((clustered.num_nodes, 16)).astype(np.float32)
    got = tgs.forward(torch.from_numpy(h), tg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jgs._forward(jnp.asarray(h), jg)),
                               **GS_TOL)


def _prepared(ds, param_dtype, features, backend="bsr"):
    """(JAX graph, features, params), (port graph, features, model) for bf16
    activations, from the JAX package's weights."""
    kw = dict(compute_dtype="bfloat16", param_dtype=param_dtype, feature_matmul=features,
              dropout=0.0, seed=3, epochs=3)
    jcfg, _, jx, jtruths = jtrain.prepare(JConfig(**kw, graphsum_backend="segment"), ds)
    tcfg, _, tx, ttruths = ttrain.prepare(GCNConfig(**kw, graphsum_backend="segment"),
                                          to_torch_dataset(ds), "cpu")
    jg, tg = _graphs(ds, backend, "bfloat16", True)
    jstate = jtrain.create_state(jcfg)
    state = ttrain.create_state(tcfg, "cpu")
    state.model.load_state_dict(convert.params_from_jax(
        {k: np.asarray(v) for k, v in jstate.params.items()}, "cpu"))
    return (jcfg, jg, jx, jtruths, jstate), (tcfg, tg, tx, ttruths, state)


def _layer0_dtype(features, param_dtype):
    """The JAX package's layer-0 output type: x's on dense x, W's on sparse x."""
    return "bfloat16" if features == "dense" else param_dtype


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("features", ["dense", "sparse"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_at_bf16_matches_jax(clustered, param_dtype, features, pair):
    """apply / apply_pair logits and the gradients at dropout 0, from the JAX
    package's weights, in its types: bf16 features; on sparse features at f32
    weights layer 0 and everything after it is f32."""
    (jcfg, jg, jx, jtruths, jstate), (tcfg, tg, tx, ttruths, state) = _prepared(
        clustered, param_dtype, features)
    model = state.model
    assert {p.dtype for p in model.parameters()} == {getattr(torch, param_dtype)}
    values = tx.values if features == "sparse" else tx
    assert values.dtype == BF16
    out_dtype = getattr(torch, _layer0_dtype(features, param_dtype))
    if pair:
        want_t, want_e = jgcn.apply_pair(jstate.params, jg, jx, key=jax.random.PRNGKey(0),
                                         dropout_rate=0.0)
        got_t, got_e = model.apply_pair(tg, tx, dropout_rate=0.0, generator=None)
        for got, want in ((got_t, want_t), (got_e, want_e)):
            assert str(got.dtype) == f"torch.{want.dtype}" and got.dtype == out_dtype
            np.testing.assert_allclose(got.detach().float().numpy(), _to_np(want), **GS_TOL)
        return
    truth = jtruths[1]
    (want_loss, (want_logits, want_acc)), want_g = jax.value_and_grad(
        jgcn.loss_fn, has_aux=True)(jstate.params, jg, jx, truth,
                                    weight_decay=jcfg.weight_decay)
    loss, logits, acc = model.loss_fn(tg, tx, ttruths[1], weight_decay=tcfg.weight_decay)
    loss.backward()
    assert logits.dtype == out_dtype and str(logits.dtype) == f"torch.{want_logits.dtype}"
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().float().numpy(), _to_np(want_logits), **GS_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    assert abs(float(acc) - float(want_acc)) <= 1.5 / int((np.asarray(truth) >= 0).sum())
    for k, p in model.named_parameters():
        assert str(p.grad.dtype) == f"torch.{want_g[k].dtype}"
        np.testing.assert_allclose(p.grad.float().numpy(), _to_np(want_g[k]), **GRAD_TOL)


@pytest.mark.parametrize("features", ["dense", "sparse"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["bsr", "pallas"])
def test_fused_epochs_at_bf16_match_jax(clustered, backend, param_dtype, features):
    """Three fused epochs (``run_epochs``) at dropout 0 from the same weights:
    losses within rtol 5e-3, accuracies within one node of their split."""
    (jcfg, jg, jx, jtruths, jstate), (tcfg, tg, tx, ttruths, state) = _prepared(
        clustered, param_dtype, features, backend)
    kw = dict(dropout_rate=0.0, weight_decay=jcfg.weight_decay, lr=jcfg.learning_rate)
    _, jm = jtrain.run_epochs(jstate, jg, jx, jtruths[1], jtruths[2], epochs=3, **kw)
    want = np.stack([np.asarray(m) for m in jm], axis=1)
    got = ttrain.run_epochs(state, tg, tx, ttruths[1], ttruths[2], epochs=3, **kw).numpy()
    np.testing.assert_allclose(got[:, [0, 2]], want[:, [0, 2]], rtol=LOSS_RTOL)
    one_node = [1.5 / int((np.asarray(jtruths[s]) >= 0).sum()) for s in (1, 2)]
    assert (np.abs(got[:, [1, 3]] - want[:, [1, 3]]) <= one_node).all()
    assert {p.dtype for p in state.model.parameters()} == {getattr(torch, param_dtype)}
    assert all(m.dtype == torch.float32 for m in (*state.opt.m.values(),
                                                   *state.opt.v.values()))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adam_keeps_f32_moments_and_the_param_type(param_dtype):
    """One Adam step from the same params and gradients: f32 moments equal to
    the JAX package's, the step taken in f32 and rounded once to the param type
    (within one bf16 ulp of JAX's, the same f32 bits otherwise)."""
    rng = np.random.default_rng(4)
    p32 = {"w1": rng.standard_normal((6, 4)).astype(np.float32),
           "w2": rng.standard_normal((4, 3)).astype(np.float32)}
    g32 = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p32.items()}
    jdt = jnp.dtype(param_dtype)
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p32.items()}
    jg_ = {k: jnp.asarray(v).astype(jdt) for k, v in g32.items()}
    hp = jadam.AdamParams(lr=0.01)
    jstate = jadam.init(jp)
    for _ in range(2):
        jp, jstate = jadam.apply(jp, jg_, jstate, hp)
    tp = convert.params_from_jax({k: np.asarray(jnp.asarray(v).astype(jdt))
                                  for k, v in p32.items()}, "cpu")
    tg_ = convert.params_from_jax({k: np.asarray(v) for k, v in jg_.items()}, "cpu")
    state = tadam.init(tp)
    for _ in range(2):
        tadam.step(tp, tg_, state, tadam.AdamParams(lr=0.01))
    for k in p32:
        assert tp[k].dtype == getattr(torch, param_dtype)
        assert state.m[k].dtype == state.v[k].dtype == torch.float32
        np.testing.assert_allclose(state.m[k].numpy(), np.asarray(jstate.m[k]), rtol=1e-6)
        np.testing.assert_allclose(state.v[k].numpy(), np.asarray(jstate.v[k]), rtol=1e-6)
        ulp = 2.0 ** -7 if param_dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(tp[k].float().numpy(), _to_np(jp[k]), rtol=ulp, atol=1e-7)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_convert_keeps_every_array_type_bitwise(param_dtype):
    """A JAX checkpoint's weights and moments come across in their own types,
    bit for bit (bf16 through a 16-bit integer view: no ml_dtypes needed)."""
    cfg = JConfig(input_dim=10, hidden_dim=6, output_dim=3, param_dtype=param_dtype)
    jstate = jtrain.create_state(cfg)
    params = {k: np.asarray(v) for k, v in jstate.params.items()}
    got = convert.params_from_jax(params, "cpu")
    for k, v in params.items():
        assert str(got[k].dtype) == f"torch.{v.dtype}"
        view = (np.int16, torch.int16) if param_dtype == "bfloat16" else (np.int32, torch.int32)
        np.testing.assert_array_equal(got[k].view(view[1]).numpy(), v.view(view[0]))
    opt = convert.adam_from_jax({k: np.asarray(v) for k, v in jstate.opt.m.items()},
                                {k: np.asarray(v) for k, v in jstate.opt.v.items()}, 5, "cpu")
    assert all(t.dtype == torch.float32 for t in (*opt.m.values(), *opt.v.values()))
    # a bf16 model takes the converted weights as they are
    state = ttrain.create_state(GCNConfig(input_dim=10, hidden_dim=6, output_dim=3,
                                          param_dtype=param_dtype), "cpu")
    state.model.load_state_dict(got)
    assert torch.equal(state.model.w1, got["w1"])


def test_dense_layer0_at_bf16_x_and_f32_w_is_within_a_rounding_of_jax():
    """bf16 x times f32 W: the port rounds W to bf16 and runs one bf16 GEMM with
    f32 sums, the JAX package promotes to an f32 product of bf16 x and rounds
    it. Both return bf16, and they differ by about one rounding of W: within 3
    bf16 ulps of the product's magnitude here."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    w = rng.standard_normal((48, 16)).astype(np.float32) * 0.1
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jnp.dot(jx, jnp.asarray(w), preferred_element_type=jnp.float32).astype(jx.dtype)
    got = dense_matmul(torch.from_numpy(x).to(BF16), torch.from_numpy(w))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    scale = np.abs(np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64)))
    err = np.abs(got.float().numpy() - _to_np(want))
    assert (err <= 3 * 2.0 ** -8 * scale).all()


@pytest.mark.parametrize("features", ["dense", "sparse"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bf16_runs_on_every_backend(clustered, param_dtype, features):
    """``train.run`` at compute bf16 on every backend, for dense and sparse
    features: finite metrics, and the weights in ``param_dtype``."""
    for backend in ("dense", "segment", "bsr", "ell", "pallas"):
        res = ttrain.run(GCNConfig(epochs=2, compute_dtype="bfloat16", param_dtype=param_dtype,
                                   feature_matmul=features, graphsum_backend=backend),
                         to_torch_dataset(clustered), device="cpu", verbose=False)
        assert np.isfinite(res.test_loss) and res.epochs_run == 2
        assert res.state.model.w1.dtype == getattr(torch, param_dtype)
