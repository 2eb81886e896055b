"""The port's model and trainer against the JAX package's, on the CPU.

Weights made by the JAX package are carried into the port (convert.py), so
both compute the same thing: logits and gradients at dropout 0, and three
fused epochs of the trainer on ``tiny_dataset`` with the bsr backend, within
1e-4 (the reduction orders differ). The port's fused loop must equal its
stepwise loop, dropout included (the same generator draws the same masks).
With ``feature_matmul='sparse'`` the port gives its dense-feature metrics
(rtol 1e-4, atol 1e-5, as tests/test_model.py holds the JAX package) and the
JAX sparse run's metrics at carried-over weights (1e-4), fused and stepwise.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.data import graph as jgraph
from cuda_gcn_tpu.models import gcn as jgcn

from cuda_gcn_torch import cli, convert
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import graph as tgraph


def to_torch_dataset(ds):
    def csr(c):
        return tds.CSR(np.asarray(c.indptr), np.asarray(c.indices))

    return tds.GCNDataset(graph=csr(ds.graph), feature_index=csr(ds.feature_index),
                          feature_value=ds.feature_value, label=ds.label,
                          split=ds.split, num_nodes=ds.num_nodes,
                          input_dim=ds.input_dim, output_dim=ds.output_dim)


def jax_params(cfg):
    state = jtrain.create_state(cfg)
    return state, {k: np.asarray(v) for k, v in state.params.items()}


def test_config_fields_match_jax():
    """The JAX package's fields and defaults, and beside them the GAT's and
    GCNII's, which the JAX package has no model for."""
    import dataclasses

    from cuda_gcn_torch.config import MODEL_FIELDS

    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(GCNConfig)}
    assert {k: v for k, v in tf.items() if k not in MODEL_FIELDS} == jf
    assert set(tf) - set(jf) == set(MODEL_FIELDS) and tf["model"] == "gcn"


@pytest.mark.parametrize("pair", [False, True])
def test_model_logits_and_grads_match_jax(tiny_dataset, pair):
    """apply / apply_pair at the same weights, dropout 0, bsr tiles of 32."""
    kw = dict(bsr_tile=32, bsr_min_edges=8, bsr_dtype="float32")
    jg = jgraph.build_graph(tiny_dataset.graph, backend="bsr", **kw)
    tds_ = to_torch_dataset(tiny_dataset)
    tg = tgraph.build_graph(tds_.graph, backend="bsr", device="cpu", **kw)
    assert tg.num_tiles > 0
    x = tiny_dataset.dense_features(np.float32)
    truth = np.where(tiny_dataset.split == 1, tiny_dataset.label, -1).astype(np.int32)
    cfg = tiny_dataset.apply_config(JConfig(seed=3))
    _, params = jax_params(cfg)
    state = ttrain.create_state(tds_.apply_config(GCNConfig(seed=3)), device="cpu")
    state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
    tx = torch.from_numpy(x)
    tt = torch.from_numpy(truth.astype(np.int64))

    if pair:
        want_t, want_e = jgcn.apply_pair({k: jnp.asarray(v) for k, v in params.items()},
                                         jg, jnp.asarray(x), key=jax.random.PRNGKey(0),
                                         dropout_rate=0.0)
        got_t, got_e = state.model.apply_pair(tg, tx, dropout_rate=0.0, generator=None)
        np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t),
                                   rtol=1e-5, atol=1e-6)
        return
    (want_loss, (want_logits, want_acc)), want_g = jax.value_and_grad(
        jgcn.loss_fn, has_aux=True)({k: jnp.asarray(v) for k, v in params.items()},
                                    jg, jnp.asarray(x), jnp.asarray(truth),
                                    weight_decay=5e-4)
    loss, logits, acc = state.model.loss_fn(tg, tx, tt, weight_decay=5e-4)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    assert float(acc) == float(want_acc)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[k]),
                                   rtol=1e-4, atol=1e-7)


def test_fused_epochs_match_jax_run_epochs(tiny_dataset):
    cfg = JConfig(epochs=3, dropout=0.0, graphsum_backend="bsr", reorder="none", seed=0)
    jcfg, jg, jx, jtruths = jtrain.prepare(cfg, tiny_dataset)
    jstate, params = jax_params(jcfg)
    kw = dict(dropout_rate=0.0, weight_decay=jcfg.weight_decay, lr=jcfg.learning_rate)
    jstate, jm = jtrain.run_epochs(jstate, jg, jx, jtruths[1], jtruths[2], epochs=3, **kw)
    want = np.stack([np.asarray(m) for m in jm], axis=1)

    tcfg = GCNConfig(epochs=3, dropout=0.0, graphsum_backend="bsr", reorder="none")
    tcfg, tg, tx, ttruths = ttrain.prepare(tcfg, to_torch_dataset(tiny_dataset), "cpu")
    assert tg.backend == "bsr" and tg.num_tiles == int(jg.bsr_tiles.shape[0]) > 0
    state = ttrain.create_state(tcfg, "cpu")
    state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
    got = ttrain.run_epochs(state, tg, tx, ttruths[1], ttruths[2], epochs=3, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                   rtol=1e-4, atol=1e-5)
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    # the Adam moments carry over too
    opt = convert.adam_from_jax({k: np.asarray(v) for k, v in jstate.opt.m.items()},
                                {k: np.asarray(v) for k, v in jstate.opt.v.items()},
                                int(jstate.opt.step), "cpu")
    for k in opt.m:
        np.testing.assert_allclose(state.opt.m[k].numpy(), opt.m[k].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_fused_epochs_match_stepwise(tiny_dataset):
    """Pass fusion changes no value: metrics and final weights equal the
    train_step + eval_step loop, with dropout 0.5 on the same generator."""
    cfg = GCNConfig(epochs=4, graphsum_backend="bsr", reorder="none")
    cfg, g, x, truths = ttrain.prepare(cfg, to_torch_dataset(tiny_dataset), "cpu")
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay,
              lr=cfg.learning_rate)
    fused = ttrain.create_state(cfg, "cpu")
    got = ttrain.run_epochs(fused, g, x, truths[1], truths[2], epochs=4, **kw)
    step = ttrain.create_state(cfg, "cpu")
    ref = []
    for _ in range(4):
        tl, ta = ttrain.train_step(step, g, x, truths[1], **kw)
        vl, va = ttrain.eval_step(step.model, g, x, truths[2],
                                  weight_decay=cfg.weight_decay)
        ref.append([float(tl), float(ta), float(vl), float(va)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    for (k, a), (_, b) in zip(fused.model.named_parameters(), step.model.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_run_prints_output_contract(tiny_dataset, capsys):
    cfg = GCNConfig(epochs=3, graphsum_backend="bsr", reorder="none")
    res = ttrain.run(cfg, to_torch_dataset(tiny_dataset), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    num = r"-?\d+\.\d{5}"
    for i, line in enumerate(lines[:3], start=1):
        assert re.fullmatch(rf"epoch={i} train_loss={num} train_acc={num} "
                            rf"val_loss={num} val_acc={num} time={num}", line), line
    assert re.fullmatch(rf"total training time={num}", lines[3])
    assert re.fullmatch(rf"test_loss={num} test_acc={num} time={num}", lines[4])
    assert res.epochs_run == 3 and np.isfinite(res.test_loss)
    # the default reorder='auto' computes the locality permutation (LPA)
    _, graph, _, _ = ttrain.prepare(GCNConfig(graphsum_backend="bsr"),
                                    to_torch_dataset(tiny_dataset), "cpu")
    assert graph.backend == "bsr" and graph.num_tiles > 0


@pytest.mark.parametrize("backend", ["segment", "pallas"])
def test_early_stopping_matches_jax(tiny_dataset, backend, capsys):
    """run with early_stopping=3 stops at the JAX run's epoch (11 of 30 at
    lr 0.1, dropout 0), with every metric row equal within 1e-4."""
    cfg = JConfig(epochs=30, dropout=0.0, learning_rate=0.1, early_stopping=3,
                  graphsum_backend=backend, seed=0)
    want = jtrain.run(cfg, tiny_dataset, verbose=False)
    _, params = jax_params(tiny_dataset.apply_config(cfg))
    tcfg = GCNConfig(epochs=30, dropout=0.0, learning_rate=0.1, early_stopping=3,
                     graphsum_backend=backend, seed=0)
    tdata = to_torch_dataset(tiny_dataset)
    state = ttrain.create_state(tdata.apply_config(tcfg), "cpu")
    state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
    got = ttrain.run(tcfg, tdata, device="cpu", initial_state=state)
    assert got.epochs_run == want.epochs_run == 11
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    np.testing.assert_allclose([[h[k] for k in keys] for h in got.history],
                               [[h[k] for k in keys] for h in want.history],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.test_loss, want.test_loss, rtol=1e-4, atol=1e-4)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[10].startswith("epoch=11 ") and lines[11] == "Early stopping..."


def test_early_stopping_loop_equals_stepwise(tiny_dataset):
    """run_epochs_es runs train_step + eval_step per epoch (6 adjacency passes)
    and stops as the reference's host loop does (gcn.cpp:142-150)."""
    cfg = GCNConfig(epochs=30, learning_rate=0.1, graphsum_backend="segment")
    cfg, g, x, truths = ttrain.prepare(cfg, to_torch_dataset(tiny_dataset), "cpu")
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay,
              lr=cfg.learning_rate)
    got, stopped = ttrain.run_epochs_es(ttrain.create_state(cfg, "cpu"), g, x, truths[1],
                                        truths[2], epochs=30, es_window=3, **kw)
    step = ttrain.create_state(cfg, "cpu")
    ref, losses = [], []
    for epoch in range(1, 31):
        tl, ta = ttrain.train_step(step, g, x, truths[1], **kw)
        vl, va = ttrain.eval_step(step.model, g, x, truths[2], weight_decay=cfg.weight_decay)
        ref.append([float(tl), float(ta), float(vl), float(va)])
        losses.append(float(vl))
        if epoch >= 3 and losses[-1] > sum(losses[-3:]) / 3:
            break
    assert stopped == (len(ref) < 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_cli_runs_on_cpu_and_reports_missing_input(capsys):
    assert cli.main(["synth-cora", "--epochs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "RUNNING ON CPU" in out and "epoch=2 " in out and "test_acc=" in out
    assert cli.main(["no-such-profile", "--device", "cpu"]) == 1


@pytest.mark.parametrize("args", [["--backend", "pallas"], ["--backend", "ell"],
                                  ["--backend", "bsr"],
                                  ["--backend", "pallas", "--early-stopping", "2"]])
def test_cli_backends_and_early_stopping(capsys, args):
    """The ell/pallas backends, bsr with the permutation computed (synth-cora
    has no cached one), and --early-stopping print the output contract."""
    epochs = "40" if "--early-stopping" in args else "2"
    assert cli.main(["synth-cora", "--epochs", epochs, "--device", "cpu", *args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"test_loss=\S+ test_acc=\S+ time=\S+", lines[-1])
    assert lines[-2].startswith("total training time=")
    if "--early-stopping" in args:
        assert lines[-3] == "Early stopping..."
    else:
        assert lines[-3].startswith(f"epoch={epochs} ")


def _sparse_prepared(tiny_dataset, feature_matmul):
    cfg = GCNConfig(epochs=3, dropout=0.0, feature_matmul=feature_matmul)
    return ttrain.prepare(cfg, to_torch_dataset(tiny_dataset), "cpu")


def test_sparse_feature_path_matches_dense(tiny_dataset):
    """Eval logits and fused-epoch metrics at dropout 0 equal the dense-feature
    path's (tests/test_model.py:97-123 for the JAX package)."""
    from cuda_gcn_torch.ops.matmul import SparseFeatures

    cfg, graph, x_d, truths = _sparse_prepared(tiny_dataset, "dense")
    _, _, x_s, _ = _sparse_prepared(tiny_dataset, "sparse")
    assert isinstance(x_s, SparseFeatures) and x_s.n_rows == tiny_dataset.num_nodes
    assert x_s.n_cols == tiny_dataset.input_dim and x_s.nnz == len(tiny_dataset.feature_value)
    state = ttrain.create_state(cfg, "cpu")
    with torch.no_grad():
        np.testing.assert_allclose(state.model(graph, x_s).numpy(),
                                   state.model(graph, x_d).numpy(), rtol=1e-5, atol=1e-6)
    kw = dict(dropout_rate=0.0, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    got = [ttrain.run_epochs(ttrain.create_state(cfg, "cpu"), graph, x, truths[1], truths[2],
                             epochs=3, **kw).numpy() for x in (x_s, x_d)]
    np.testing.assert_allclose(got[0], got[1], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_sparse_feature_path_matches_jax_sparse(tiny_dataset, fused):
    """Three epochs at dropout 0 from the JAX run's weights: the fused loop
    against ``run_epochs``, ``train_step`` + ``eval_step`` against the same."""
    cfg = JConfig(epochs=3, dropout=0.0, seed=0, feature_matmul="sparse")
    jcfg, jg, jx, jtruths = jtrain.prepare(cfg, tiny_dataset)
    jstate, params = jax_params(jcfg)
    kw = dict(dropout_rate=0.0, weight_decay=jcfg.weight_decay, lr=jcfg.learning_rate)
    jstate, jm = jtrain.run_epochs(jstate, jg, jx, jtruths[1], jtruths[2], epochs=3, **kw)
    want = np.stack([np.asarray(m) for m in jm], axis=1)

    tcfg, tg, tx, ttruths = _sparse_prepared(tiny_dataset, "sparse")
    state = ttrain.create_state(tcfg, "cpu")
    state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
    if fused:
        got = ttrain.run_epochs(state, tg, tx, ttruths[1], ttruths[2], epochs=3, **kw).numpy()
    else:
        got = []
        for _ in range(3):
            tl, ta = ttrain.train_step(state, tg, tx, ttruths[1], **kw)
            vl, va = ttrain.eval_step(state.model, tg, tx, ttruths[2],
                                      weight_decay=tcfg.weight_decay)
            got.append([float(tl), float(ta), float(vl), float(va)])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                   rtol=1e-4, atol=1e-5)


def test_sparse_dropout_acts_on_the_values(tiny_dataset):
    """Layer-0 dropout keeps or drops each nnz value (scaled by 1/(1-p)) with
    the trainer's generator: held by distribution, as for dense x."""
    from cuda_gcn_torch.models.gcn import _layer0_transform

    _, _, x, _ = _sparse_prepared(tiny_dataset, "sparse")
    w = torch.eye(x.n_cols)
    gen = torch.Generator().manual_seed(0)
    out = _layer0_transform(x, w, 0.5, gen, True)
    dense = torch.from_numpy(tiny_dataset.dense_features(np.float32))
    kept = out != 0
    np.testing.assert_allclose(out[kept].numpy(), 2 * dense[kept].numpy(), rtol=1e-6)
    assert not out[dense == 0].any()
    assert 0.4 < float(kept.sum()) / float((dense != 0).sum()) < 0.6
    np.testing.assert_array_equal(_layer0_transform(x, w, 0.5, gen, False).numpy(),
                                  dense.numpy())


def test_sparse_features_on_a_huge_graph_name_the_banded_layout(tiny_dataset, monkeypatch):
    """The port has no band threshold: sparse features stay CSR at any node
    count (tests/test_torch_large_features.py holds them against the JAX
    package's bands at 2^19 nodes), and 'banded' is no feature_matmul."""
    from cuda_gcn_torch.ops import matmul as tmm

    assert not hasattr(tmm, "BANDED_FEATURES_MIN_ROWS")
    assert isinstance(_sparse_prepared(tiny_dataset, "sparse")[2], tmm.SparseFeatures)
    _sparse_prepared(tiny_dataset, "dense")
    _, graph, x, _ = ttrain.prepare(GCNConfig(compute_dtype="bfloat16", graphsum_backend="bsr"),
                                    to_torch_dataset(tiny_dataset), "cpu")
    assert x.dtype == torch.bfloat16 and graph.resid.coef.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        GCNConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="feature_matmul"):
        ttrain.prepare(GCNConfig(feature_matmul="banded"), to_torch_dataset(tiny_dataset),
                       "cpu")
