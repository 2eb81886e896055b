"""The port's GCNII (models/gcnii.py, ops/blend.py) on the CPU against the
plain reference in tests/gcnii_reference.py.

The graph is test_torch_gat's small skewed one (a row of 300 slots, longer
than an ELL chunk, so its work items are split). At 8 layers of 16 and the
same seeded weights the port and the reference agree on the logits, the loss
and every parameter's gradient, and over 3 Adam steps of the fused trainer,
with dropout off and with the port's masks fed in (read back from the
tensors saved for the backward: the dropped x, then each layer's kept mask).
The blended aggregation's plain form is (1 − α)·Â·h + α·h0 and its backward
autograd's of that; the pair's evaluation half is the forward without
dropout; θ_l is ln(λ/l + 1). The loop's hooks leave the GCN's and the GAT's
operations as they were: their outputs and gradients equal, bit for bit,
those of the loop as it stood before (restated here).
"""

import ast
import dataclasses
import math
import os

import numpy as np
import pytest
import torch
from test_torch_gat import assert_close, gat_config, skewed_dataset

from cuda_gcn_torch import cli, train
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.models import gcn as tgcn
from cuda_gcn_torch.models.gcnii import GCNII, theta
from cuda_gcn_torch.ops import blend as tblend
from cuda_gcn_torch.ops.dropout import dropout
from cuda_gcn_torch.ops.matmul import dense_matmul
from cuda_gcn_torch.parallel import sharded
from tests import gcnii_reference as ref

N, F, H, LAYERS = 400, 24, 16, 8


def gcnii_config(rate=0.0, seed=7, layers=LAYERS, **kw):
    return GCNConfig(model="gcnii", hidden_dim=H, layers=layers, dropout=rate,
                     learning_rate=0.01, weight_decay=5e-4, seed=seed,
                     graphsum_backend="ell", **kw)


@pytest.fixture(scope="module")
def prepared():
    ds = skewed_dataset()
    cfg, graph, x, truths = train.prepare(gcnii_config(), ds, "cpu")
    return ds, graph, x, truths


def ref_inputs(ds, truths):
    x = torch.from_numpy(ds.dense_features(np.float32))
    return x, ref.graph_of(ds.graph.indptr, ds.graph.indices), truths[1], truths[2]


def settings(cfg) -> ref.Settings:
    return ref.Settings(alpha=cfg.alpha, lamda=cfg.lamda, weight_decay=cfg.weight_decay,
                        conv_weight_decay=cfg.conv_weight_decay)


class MaskReader:
    """Each training step's masks, from the tensors its forward saves: the
    dropped x [N, F] opens a step; every kept mask [N, H] (bool) follows, one
    a convolution and the output layer's last."""

    def __init__(self):
        self.steps = []

    def pack(self, t):
        if t.is_floating_point() and tuple(t.shape) == (N, F):
            self.steps.append({"x": t != 0, "hidden": []})
        elif t.dtype == torch.bool and tuple(t.shape) == (N, H) and self.steps:
            self.steps[-1]["hidden"].append(t.clone())
        return t

    def drops(self, rate):
        return [ref.Dropout(x=s["x"], hidden=s["hidden"], keep=1.0 - rate) for s in self.steps]


def dense_adj(graph) -> torch.Tensor:
    """Â as a dense [N, N] matrix, from the port's ELL plan."""
    adj = torch.zeros(N, N, dtype=torch.float64)
    for b in range(len(graph.ell.widths)):
        rows, cols, coef = graph.ell.bucket(b)
        for r, cs, ws in zip(rows.tolist(), cols.tolist(), coef.tolist()):
            for c, w in zip(cs, ws):
                adj[r, c] += w
    return adj


def test_reference_imports_nothing_of_the_port_or_jax():
    path = os.path.join(os.path.dirname(__file__), "gcnii_reference.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "cuda_gcn_torch",
                                                        "cuda_gcn_tpu")]
    ref.use_float32()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("layers", [1, 8, 64])
@pytest.mark.parametrize("lamda", [0.5, 1.5])
def test_theta_of_each_layer(layers, lamda):
    """θ_l = ln(λ/l + 1) for l = 1..L, in the model's order, falling with l."""
    model = GCNII(F, H, 4, layers, torch.Generator().manual_seed(0), lamda=lamda)
    want = [math.log(lamda / k + 1.0) for k in range(1, layers + 1)]
    assert list(model.thetas) == want == [theta(lamda, k) for k in range(1, layers + 1)]
    assert all(a > b for a, b in zip(want, want[1:]))
    assert model.thetas[0] == math.log1p(lamda)


def test_weights_are_the_reference_draws_in_its_order():
    """The parameters' names, order and values are the reference's from the
    job's seed: the convolutions, then the dense layers' weight and bias."""
    model = GCNII(F, H, 4, LAYERS, torch.Generator().manual_seed(11))
    params = ref.init_params(F, H, 4, LAYERS, 11)
    assert list(params) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), params[name]), name
    assert float(model.w1.detach().abs().max()) <= H ** -0.5
    assert float(model.w_in.detach().abs().max()) <= F ** -0.5
    assert [tuple(w.shape) for w in model.weights()] == \
        [(F, H)] + [(H, H)] * LAYERS + [(H, 4)]


@pytest.mark.parametrize("alpha", [0.1, 0.0, 1.0])
def test_blend_is_the_residual_composition(prepared, alpha):
    """``blend``'s plain form is (1 − α)·Â·h + α·h0 (Â dense, f64), and its
    backward autograd's of that composition; the pair gives each half's and
    differentiates the training half alone."""
    _, graph, _, _ = prepared
    gen = torch.Generator().manual_seed(5)
    h, h0, he, h0e, g = (torch.randn(N, H, generator=gen) for _ in range(5))
    adj = dense_adj(graph)
    a, b = 1.0 - alpha, alpha
    leaves = [t.clone().requires_grad_(True) for t in (h, h0)]
    got = tblend.blend(*leaves, graph, a, b)
    want_f64 = a * (adj @ h.double()) + b * h0.double()
    torch.testing.assert_close(got.double(), want_f64, rtol=1e-5, atol=1e-6)
    dh, dh0 = torch.autograd.grad(got, leaves, g)
    comp = [t.double().clone().requires_grad_(True) for t in (h, h0)]
    want = torch.autograd.grad(a * (adj @ comp[0]) + b * comp[1], comp, g.double())
    torch.testing.assert_close(dh.double(), want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dh0.double(), want[1], rtol=1e-7, atol=0)
    assert torch.equal(dh0, b * g)
    st, se = tblend.blend_pair(leaves[0], he, leaves[1], h0e, graph, a, b)
    assert st.requires_grad and not se.requires_grad
    torch.testing.assert_close(st.double(), want_f64, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(se.double(), a * (adj @ he.double()) + b * h0e.double(),
                               rtol=1e-5, atol=1e-6)
    pt, p0 = torch.autograd.grad(st, leaves, g)
    assert torch.equal(pt, dh) and torch.equal(p0, dh0)  # the same transposed pass


def test_blend_rounds_as_the_kernel_stores():
    """The plain form rounds a·sum and b·h0 and then their sum, as the
    kernel's store does (no fused multiply-add)."""
    ds = skewed_dataset()
    _, graph, _, _ = train.prepare(gcnii_config(), ds, "cpu")
    gen = torch.Generator().manual_seed(9)
    h, h0 = torch.randn(N, H, generator=gen), torch.randn(N, H, generator=gen)
    s = tblend.ell_spmm_plain(graph.ell, h)
    assert torch.equal(tblend.blend_plain(graph.ell, h, (h0,), 0.9, 0.1), 0.9 * s + 0.1 * h0)
    assert torch.equal(tblend.blend_plain(graph.ell, h, None, 0.9, 0.0), 0.9 * s)


@pytest.mark.parametrize("masks", [False, True])
def test_logits_loss_and_gradients_match_the_reference(prepared, masks):
    """One training forward and backward of the port's model against the
    reference at the same seeded weights: logits, loss, each parameter's
    gradient; with ``masks`` at dropout 0.6, the port's masks fed to the
    reference."""
    ds, graph, x, truths = prepared
    rate = 0.6 if masks else 0.0
    cfg = ds.apply_config(gcnii_config(rate))
    state = train.create_state(cfg, "cpu")
    params = ref.init_params(F, H, cfg.output_dim, LAYERS, cfg.seed)
    reader = MaskReader()
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        loss, logits, _ = state.model.loss_fn(graph, x, truths[1], weight_decay=5e-4,
                                              dropout_rate=rate, generator=state.generator,
                                              training=True)
        loss.backward()
    drop = reader.drops(rate)[0] if masks else None
    if masks:
        assert len(reader.steps) == 1 and len(drop.hidden) == LAYERS + 1
    want_loss, want_logits, want_grads = ref.gradients(params, ref_inputs(ds, truths)[0],
                                                       ref_inputs(ds, truths)[1], truths[1],
                                                       settings(cfg), drop)
    assert_close(logits.detach(), want_logits, "logits")
    assert_close(loss.detach(), want_loss, "loss")
    for name, p in state.model.named_parameters():
        assert_close(p.grad, want_grads[name], f"grad {name}")


@pytest.mark.parametrize("masks", [False, True])
def test_three_adam_steps_of_the_fused_trainer(prepared, masks):
    """Three epochs of ``train.run_epochs_chunked`` (the pass-fused pair)
    against three reference steps: each step's training loss, the
    validation loss after it, the final weights."""
    ds, graph, x, truths = prepared
    rate = 0.6 if masks else 0.0
    cfg = ds.apply_config(gcnii_config(rate))
    state = train.create_state(cfg, "cpu")
    params = ref.init_params(F, H, cfg.output_dim, LAYERS, cfg.seed)
    reader = MaskReader()
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        rows = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=3,
                                        dropout_rate=rate, weight_decay=5e-4, lr=0.01)
    drops = reader.drops(rate) if masks else [None] * 3
    assert len(drops) == 3
    xr, g, t1, t2 = ref_inputs(ds, truths)
    tl, vl, final = ref.train_steps(params, xr, g, t1, t2, settings(cfg), 0.01, drops)
    assert_close(rows[:, 0], torch.tensor(tl), "train loss")
    assert_close(rows[:, 2], torch.tensor(vl), "val loss")
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), final[name], rtol=1e-4, atol=1e-6,
                                   msg=f"weights {name}")


def test_fused_loop_equals_the_stepwise_loop(prepared):
    """The pair draws the generator in the stepwise forward's order (x's
    mask, then each layer's), so both loops train the same steps."""
    ds, graph, x, truths = prepared
    cfg = ds.apply_config(gcnii_config(0.6))
    kw = dict(dropout_rate=0.6, weight_decay=5e-4, lr=0.01)
    a = train.create_state(cfg, "cpu")
    fused = train.run_epochs(a, graph, x, truths[1], truths[2], epochs=3, **kw)
    b = train.create_state(cfg, "cpu")
    stepwise = torch.stack([train._es_epoch(b, graph, x, truths[1], truths[2], **kw)
                            for _ in range(3)])
    torch.testing.assert_close(fused, stepwise, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("features", ["dense", "sparse"])
def test_pair_eval_half_is_the_eval_forward(features):
    """At the same weights the evaluation half of ``apply_pair`` (dropout on
    the training half) is ``forward(training=False)``; only the training
    half has a gradient."""
    cfg = gcnii_config(0.6, feature_matmul=features)
    cfg, graph, x, _ = train.prepare(cfg, skewed_dataset(), "cpu")
    model = train.create_state(cfg, "cpu").model
    lt, le = model.apply_pair(graph, x, dropout_rate=cfg.dropout,
                              generator=torch.Generator().manual_seed(1))
    assert lt.requires_grad and not le.requires_grad
    want = model(graph, x, training=False).detach()
    assert not torch.allclose(lt.detach(), want)
    np.testing.assert_allclose(le.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_l2_penalty_is_two_groups():
    """conv_wd/2 · Σ||W_l||² + wd/2 · the dense layers' weights and biases."""
    model = GCNII(F, H, 4, 3, torch.Generator().manual_seed(2), conv_weight_decay=0.01)
    conv = sum(float(torch.sum(w.detach().double() ** 2)) for w in model.convs())
    dense = sum(float(torch.sum(p.detach().double() ** 2))
                for p in (model.w_in, model.b_in, model.w_out, model.b_out))
    np.testing.assert_allclose(float(model.l2_penalty(5e-4).detach()),
                               0.005 * conv + 2.5e-4 * dense, rtol=1e-6)


def test_a_chunked_job_trains(prepared):
    """A ``run_epochs_chunked`` job at the paper's 64 layers: finite rows,
    the training loss falling, and an evaluation after it."""
    ds, graph, x, truths = prepared
    cfg = ds.apply_config(gcnii_config(0.6, layers=64))
    state = train.create_state(cfg, "cpu")
    rows = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=6, chunk=4,
                                    dropout_rate=0.6, weight_decay=5e-4, lr=0.01)
    assert rows.shape == (6, 4) and bool(torch.isfinite(rows).all())
    assert float(rows[-1, 0]) < float(rows[0, 0])
    loss, acc = train.eval_step(state.model, graph, x, truths[3], weight_decay=5e-4)
    assert math.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0


def test_cli_trains_gcnii_with_the_papers_settings(capsys):
    """``--model gcnii``: width 64, dropout 0.6, lr 0.01, L2 5e-4 and 0.01, 64
    layers, α 0.1, λ 0.5 where the command gives none; it trains on ell
    ('auto' picks it) and prints the reference's lines."""
    cfg = cli.config_from_args(cli.build_argparser().parse_args(["synth-cora", "--model",
                                                                 "gcnii"]))
    assert (cfg.model, cfg.hidden_dim, cfg.dropout, cfg.learning_rate, cfg.weight_decay,
            cfg.conv_weight_decay, cfg.layers, cfg.alpha, cfg.lamda) == \
        ("gcnii", 64, 0.6, 0.01, 5e-4, 0.01, 64, 0.1, 0.5)
    cfg = cli.config_from_args(cli.build_argparser().parse_args(
        ["synth-cora", "0", "0", "32", "0", "0.5", "--model", "gcnii"]))
    assert (cfg.hidden_dim, cfg.dropout) == (32, 0.5)
    assert cli.main(["synth-cora", "--model", "gcnii", "--epochs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "epoch=2 " in out and "test_loss=" in out


@pytest.mark.parametrize("extra", [["--mesh", "2"], ["--timing"], ["--backend", "bsr"]])
def test_cli_refuses_what_gcnii_cannot_run(capsys, extra):
    if extra[0] == "--backend":
        with pytest.raises(ValueError, match="model 'gcnii' aggregates over the ELL plan"):
            cli.main(["synth-cora", "--model", "gcnii", "--device", "cpu", *extra])
        return
    assert cli.main(["synth-cora", "--model", "gcnii", "--device", "cpu", *extra]) == 1
    assert "--model gcnii" in capsys.readouterr().err


@pytest.mark.parametrize("model", ["gcn", "gat", "gcnii"])
def test_one_rule_decides_who_shards(model, capsys):
    """``shards`` of the model's class is what ``--mesh`` and the sharded
    trainer read: the GCN shards; the GAT and GCNII are refused by both, in
    the words and with the exit codes of before."""
    cfg = GCNConfig(model=model)
    cls = train.model_class(cfg)
    assert cls.shards == (model == "gcn")
    if model == "gcn":
        return
    with pytest.raises(ValueError) as got:
        sharded.prepare_sharded(cfg, skewed_dataset(), 2)
    assert str(got.value) == (f"the sharded trainer trains the GCN; model {model!r} is "
                              f"single-device")
    assert cli.main(["synth-cora", "--model", model, "--device", "cpu", "--mesh", "2"]) == 1
    assert f"--mesh trains the GCN; --model {model} is single-device" in capsys.readouterr().err


@pytest.mark.parametrize("bad,match", [
    (dict(compute_dtype="bfloat16"), "runs in float32"),
    (dict(param_dtype="bfloat16"), "runs in float32"),
    (dict(hidden_dims=(16, 16)), "width from hidden_dim"),
    (dict(layers=0), "layers >= 1"),
    (dict(alpha=1.5), "0 <= alpha <= 1"),
    (dict(lamda=0.0), "lamda > 0"),
])
def test_config_refuses_what_gcnii_cannot_run(bad, match):
    with pytest.raises(ValueError, match=match):
        GCNConfig(model="gcnii", **bad)


def test_gcn_and_gat_ignore_the_gcnii_fields():
    """The GCN's weights are the same whatever GCNII's fields say."""
    a = train.create_state(GCNConfig(input_dim=F, output_dim=4), "cpu")
    b = train.create_state(GCNConfig(input_dim=F, output_dim=4, layers=3, alpha=0.5, lamda=2.0,
                                     conv_weight_decay=1.0), "cpu")
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n


# ---- the loop as it stood before its hooks, for the GCN and the GAT ----------

def _loop_before(model, graph, x, rate, generator, training):
    """``GraphModel.forward`` before ``_transform`` and ``keeps_h0``."""
    h = x
    for i, w in enumerate(model.weights()):
        if i == 0:
            z = tgcn._layer0_transform(h, w, rate, generator, training)
        else:
            z = dense_matmul(dropout(h, rate, generator, training), w)
        h = model._layer(i, z, graph, tgcn.GRAPHSUMS, generator, training)
    return h


def _pair_before(model, graph, x, rate, generator):
    """``GraphModel.apply_pair`` before ``_transform_pair`` and ``keeps_h0``."""
    for i, w in enumerate(model.weights()):
        if i == 0:
            zt, ze = tgcn.layer0_pair(x, w, rate, generator)
        else:
            zt = dense_matmul(dropout(ht, rate, generator, True), w)
            del ht
            with torch.no_grad():
                ze = dense_matmul(he, w)
        ht, he = model._layer_pair(i, zt, ze, graph, tgcn.GRAPHSUMS, generator)
    return ht, he


@pytest.mark.parametrize("setup", ["gcn-dense", "gcn-sparse", "gcn-3-layers", "gat"])
def test_loop_hooks_leave_the_gcn_and_the_gat_bit_for_bit(setup):
    """Single and pair forwards, and the gradients of a loss of their
    outputs, equal to the bit (``torch.equal``) those of the loop as it was
    before its hooks, at the same weights and dropout draws. One thread: the
    sparse features' dW on the CPU adds in another order on several."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _compare_loops(setup)
    finally:
        torch.set_num_threads(threads)


def _compare_loops(setup):
    if setup == "gat":
        cfg = gat_config(rate=0.6)
    else:
        cfg = GCNConfig(graphsum_backend="ell", dropout=0.5, reorder="none",
                        hidden_dims=(16, 8) if setup == "gcn-3-layers" else None,
                        feature_matmul="sparse" if setup == "gcn-sparse" else "dense")
    cfg, graph, x, _ = train.prepare(cfg, skewed_dataset(), "cpu")
    model = train.create_state(cfg, "cpu").model
    assert not model.keeps_h0

    def run(fn):
        model.zero_grad(set_to_none=True)
        outs = fn(torch.Generator().manual_seed(3))
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.square(outs[0]).sum().backward()
        return [o.detach() for o in outs] + [p.grad.clone() for p in model.parameters()]

    dumps = [
        (run(lambda g: model(graph, x, dropout_rate=cfg.dropout, generator=g, training=True)),
         run(lambda g: _loop_before(model, graph, x, cfg.dropout, g, True))),
        (run(lambda g: model.apply_pair(graph, x, dropout_rate=cfg.dropout, generator=g)),
         run(lambda g: _pair_before(model, graph, x, cfg.dropout, g))),
    ]
    for now, before in dumps:
        assert len(now) == len(before)
        for a, b in zip(now, before):
            assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(model(graph, x), _loop_before(model, graph, x, 0.0, None, False))


def test_a_gcnii_step_saves_what_the_benchmark_reads(prepared):
    """A fused training step saves, in order, the dropped x and one kept mask
    a convolution and the output layer (the masks the benchmark reads back),
    and no [N, H] tensor of both halves."""
    ds, graph, x, truths = prepared
    cfg = ds.apply_config(gcnii_config(0.6))
    state = train.create_state(cfg, "cpu")
    reader = MaskReader()
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=1,
                                 dropout_rate=0.6, weight_decay=5e-4, lr=0.01)
    (step,) = reader.steps
    assert len(step["hidden"]) == LAYERS + 1
    shares = [float(m.float().mean()) for m in step["hidden"]]
    assert all(abs(s - 0.4) < 0.05 for s in shares), shares
    assert len({m.numpy().tobytes() for m in step["hidden"]}) == LAYERS + 1


def test_gcnii_config_round_trips():
    cfg = gcnii_config(0.6)
    assert dataclasses.replace(cfg, seed=3).layers == LAYERS
    assert train.model_class(cfg) is GCNII and GCNII.graph_backend("auto", N) == "ell"
