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

from cuda_gcn_torch import cli, kernels, train
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.models import gcn as tgcn
from cuda_gcn_torch.models import gcnii as gcnii_module
from cuda_gcn_torch.models.gcnii import GCNII, theta
from cuda_gcn_torch.ops import blend as tblend
from cuda_gcn_torch.ops import epilogue as tepi
from cuda_gcn_torch.ops import matmul as tmm
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


# ---- the convolution epilogue (ops/epilogue.py) -------------------------------

def _epilogue_inputs(n=N, h=H, dtype=torch.float32, seed=4):
    gen = torch.Generator().manual_seed(seed)
    st, se, g = (torch.randn(n, h, generator=gen, dtype=dtype) for _ in range(3))
    w = ((torch.rand(h, h, generator=gen, dtype=dtype) * 2 - 1) * h ** -0.5)
    seeds = torch.empty(2, dtype=torch.int64).random_(generator=gen)
    return st, se, g, w, seeds


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("rate", [0.6, 0.5, 0.0])
def test_epilogue_plain_is_the_aten_chain(concat, rate):
    """The plain epilogue of a convolution (layer 3's θ) is what ATen's chain
    gave, with the epilogue's mask: each half's addmm(s, s, W, 1 − θ, θ) and
    ReLU, the training half dropped out, forward within the f32 rounding
    of its product and backward (gs, dW) within that of theirs; the halves
    side by side in one [N, 2H] tensor where ``concat``, else apart."""
    st, se, g, w, seeds = _epilogue_inputs()
    t = theta(0.5, 3)
    stl, wl = st.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ht, he = tepi._Epilogue.apply(stl, wl, se, seeds, t, rate, concat)
    keep = tepi.gcnii_keep(seeds.tolist(), N, H, rate)
    sa, wa = st.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want_t = torch.where(keep, torch.relu(torch.addmm(sa, sa, wa, beta=1.0 - t, alpha=t))
                         / (1.0 - rate), torch.zeros(()))
    want_e = torch.relu(torch.addmm(se, se, w, beta=1.0 - t, alpha=t))
    torch.testing.assert_close(ht, want_t.detach(), rtol=2e-6, atol=1e-6)
    torch.testing.assert_close(he, want_e, rtol=2e-6, atol=1e-6)
    assert ht.requires_grad and not he.requires_grad
    if concat:
        assert tblend.side_by_side(ht, he) is not None
        assert ht.data_ptr() + 4 * H == he.data_ptr() and ht.stride() == (2 * H, 1)
    else:
        assert ht.is_contiguous() and he.is_contiguous() and tblend.side_by_side(ht, he) is None
    gs, dw = torch.autograd.grad(ht, (stl, wl), g)
    want_gs, want_dw = torch.autograd.grad(want_t, (sa, wa), g)
    torch.testing.assert_close(gs, want_gs, rtol=2e-6, atol=1e-6)
    torch.testing.assert_close(dw, want_dw, rtol=2e-5, atol=1e-5)


def test_epilogue_gradients_pass_gradcheck_in_f64():
    """The epilogue's backward (its plain version, as the kernel computes it)
    against numerical derivatives in f64, in s_t and W, with a mask drawn."""
    st, se, _, w, seeds = _epilogue_inputs(n=12, h=8, dtype=torch.float64)
    st.requires_grad_(True)
    w.requires_grad_(True)

    def fn(s, m):
        return tepi._Epilogue.apply(s, m, se, seeds, theta(0.5, 2), 0.6, True)[0]

    assert torch.autograd.gradcheck(fn, (st, w), eps=1e-6, atol=1e-8, rtol=1e-6)
    assert int(tepi.gcnii_keep(seeds.tolist(), 12, 8, 0.6).sum()) not in (0, 96)


def test_epilogue_gradients_through_a_convolution_in_f64(prepared):
    """A convolution of the pair on the small graph, (1 − α)·Â·h + α·h0 with
    Â dense in f64 (the blended pass's plain form sums in f32), then the
    epilogue: gradcheck in f64 of the training half in h, h0 and W (a width
    of 4, a few rows)."""
    _, graph, _, _ = prepared
    adj = dense_adj(graph)
    gen = torch.Generator().manual_seed(8)
    h, h0, se = (torch.randn(N, 4, generator=gen, dtype=torch.float64) for _ in range(3))
    w = torch.randn(4, 4, generator=gen, dtype=torch.float64) * 0.5
    seeds = torch.tensor([5, 6])
    picks = torch.tensor([0, 7, 123, 399])

    def fn(a, b, m):
        st = 0.9 * (adj @ a) + 0.1 * b
        return tepi._Epilogue.apply(st, m, se, seeds, theta(0.5, 1), 0.5, True)[0][picks]

    leaves = [t.clone().requires_grad_(True) for t in (h, h0, w)]
    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-8, rtol=1e-6,
                                    fast_mode=True)


def test_gcnii_keep_restates_the_kernel_layout():
    """Element (r, c) of the mask is word c % 4 of Philox at counter r·H/4 +
    c/4 (two words) and the offset (two words) under the seed as its key,
    kept below q·2^32; each launch's seeds give a mask of their own; the keep
    share is near 1 − p; p = 0 keeps every element and p = 1 none."""
    n, h, rate = 300, 64, 0.6
    seeds = [0x123456789ABCDEF0 - 2**64, 0x0FEDCBA987654321]
    keep = tepi.gcnii_keep(seeds, n, h, rate)
    seed, offset = (v % 2**64 for v in seeds)
    thresh = kernels.gcnii_dropout(rate)[1]
    for r, c in [(0, 0), (0, 5), (7, 63), (299, 32), (150, 17)]:
        call = r * (h // 4) + c // 4
        u = tmm.philox4x32((seed & 0xFFFFFFFF, seed >> 32), torch.tensor(
            [[call & 0xFFFFFFFF, call >> 32, offset & 0xFFFFFFFF, offset >> 32]]))
        assert bool(keep[r, c]) == (int(u[0, c % 4]) < thresh)
    q = 1.0 - rate
    z = (int(keep.sum()) - q * keep.numel()) / (q * (1 - q) * keep.numel()) ** 0.5
    assert abs(z) < 5, z
    others = [tepi.gcnii_keep([seeds[0], seeds[1] + k], n, h, rate) for k in (1, 2)]
    others.append(tepi.gcnii_keep([seeds[0] + 1, seeds[1]], n, h, rate))
    assert all(not torch.equal(keep, o) for o in others)
    agree = float((keep == others[0]).float().mean())
    assert abs(agree - (q * q + (1 - q) ** 2)) < 0.02, agree
    assert bool(tepi.gcnii_keep(seeds, n, h, 0.0).all())
    assert not bool(tepi.gcnii_keep(seeds, n, h, 1.0).any())


@pytest.mark.parametrize("rate,scale,thresh", [(0.6, 2.5, 1717986944), (0.5, 2.0, 2**31),
                                               (0.0, 1.0, 2**32), (1.0, 0.0, 0)])
def test_gcnii_dropout_constants(rate, scale, thresh):
    """The kept values' factor is 1/q in f32 (q = 1 − p in f32, divided in
    f32) and the threshold q·2^32, at the edges too; a rate outside [0, 1] is
    refused."""
    assert kernels.gcnii_dropout(rate) == (scale, thresh)
    with pytest.raises(ValueError, match="dropout rate"):
        kernels.gcnii_dropout(1.5)


@pytest.mark.parametrize("h", [64, 16, 40])
def test_relu_bits_round_trip(h):
    """ReLU's sign packs into ⌈h/32⌉ int32 words a row, bit c % 32 of word
    c / 32 for column c (bit 31 too), and unpacks to itself."""
    pos = torch.rand(9, h, generator=torch.Generator().manual_seed(h)) < 0.5
    pos[0] = True
    words = tepi.pack_bits(pos)
    assert words.dtype == torch.int32 and tuple(words.shape) == (9, -(-h // 32))
    assert torch.equal(tepi.unpack_bits(words, h), pos)
    assert int(words[0, 0]) == (-1 if h >= 32 else 2**h - 1)
    assert int(words[1, 0]) & 1 == int(pos[1, 0]) and (int(words[1, 0]) >> 5) & 1 == int(pos[1, 5])


def test_the_epilogue_is_for_the_card():
    """``fuses`` takes f32 card tensors at a built width only: a CPU tensor
    keeps ATen's chain (the CPU trainers run as before)."""
    assert kernels.GCNII_EPILOGUE_WIDTHS == (64,)
    assert not tepi.fuses(torch.zeros(4, 64))
    assert not tepi.fuses(torch.zeros(4, 64, device="meta"))


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """GCNII's pair takes the epilogue on the CPU too (its plain version)."""
    monkeypatch.setattr(gcnii_module, "fuses", lambda s: True)


@pytest.mark.parametrize("masks", [False, True])
def test_the_epilogue_path_trains_the_reference_steps(prepared, fused_on_cpu, masks):
    """The fused trainer's pair through the epilogue (its plain version):
    three Adam steps against the reference, with the masks read back from the
    tensors the steps save (one bool [N, H] a layer, in layer order: any other
    order feeds the reference other masks)."""
    test_three_adam_steps_of_the_fused_trainer(prepared, masks)


def test_the_epilogue_path_saves_one_mask_a_layer(prepared, fused_on_cpu):
    """Through the epilogue a fused step saves exactly layers + 1 bool [N, H]
    tensors (layer 1's dropout, then one an epilogue), each at the keep share,
    all distinct; no [N, H] float of a layer's output and no [N, 2H] tensor;
    the first convolution's input from ATen's dropout, every later one from
    the epilogue, which launches once a convolution."""
    ds, graph, x, truths = prepared
    cfg = ds.apply_config(gcnii_config(0.6))
    state = train.create_state(cfg, "cpu")
    saved, calls = [], []
    real = tepi._Epilogue.forward

    def counted(ctx, *args):
        calls.append(args[-1])
        return real(ctx, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tepi._Epilogue, "forward", staticmethod(counted))
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=1,
                                     dropout_rate=0.6, weight_decay=5e-4, lr=0.01)
    assert calls == [True] * (LAYERS - 1) + [False]
    masks = [t for t in saved if t.dtype == torch.bool and tuple(t.shape) == (N, H)]
    assert len(masks) == LAYERS + 1
    assert all(abs(float(m.float().mean()) - 0.4) < 0.05 for m in masks)
    assert len({m.numpy().tobytes() for m in masks}) == LAYERS + 1
    assert not [t for t in saved if tuple(t.shape) == (N, 2 * H)]
    floats = [t for t in saved if t.is_floating_point() and tuple(t.shape) == (N, H)]
    assert len(floats) == LAYERS + 2  # h0's ReLU, each convolution's s_t, the output's input


def test_the_epilogue_path_leaves_the_eval_half_and_the_single_loop(prepared, fused_on_cpu):
    """Through the epilogue the pair's evaluation half is still the
    evaluation forward, and the training half's logits differ from it."""
    test_pair_eval_half_is_the_eval_forward("dense")


# ---- the GCN's and the GAT's trainers, as before the epilogue's hook --------

def _pair_before_hook(self, graph, x, *, dropout_rate, generator, graphsums=tgcn.GRAPHSUMS):
    """``GraphModel.apply_pair`` before ``_dropped_pair``."""
    h0 = None
    for i, w in enumerate(self.weights()):
        if i == 0:
            zt, ze = tgcn.layer0_pair(x, w, dropout_rate, generator)
        else:
            hd = dropout(ht, dropout_rate, generator, True)
            del ht
            zt, ze = self._transform_pair(i, hd, he, w, h0, graph)
        ht, he = self._layer_pair(i, zt, ze, graph, graphsums, generator)
        if i == 0 and self.keeps_h0:
            h0 = (ht, he)
    return ht, he


@pytest.mark.parametrize("trainer", ["fused", "early_stopping"])
@pytest.mark.parametrize("setup", ["gcn-dense", "gcn-sparse", "gcn-3-layers", "gat"])
def test_gcn_and_gat_trainers_run_as_before_the_hook(setup, trainer, monkeypatch):
    """Three epochs of the fused and of the early-stopping trainer equal, to
    the bit (metrics, every parameter, Adam's moments), those of the loop as
    it stood before ``_dropped_pair``. One thread, as above."""
    if setup == "gat":
        cfg = gat_config(rate=0.6)
    else:
        cfg = GCNConfig(graphsum_backend="ell", dropout=0.5, reorder="none",
                        hidden_dims=(16, 8) if setup == "gcn-3-layers" else None,
                        feature_matmul="sparse" if setup == "gcn-sparse" else "dense")
    cfg, graph, x, truths = train.prepare(cfg, skewed_dataset(), "cpu")
    kw = dict(dropout_rate=cfg.dropout, weight_decay=5e-4, lr=0.01)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    runs = []
    try:
        for before in (False, True):
            if before:
                monkeypatch.setattr(tgcn.GraphModel, "apply_pair", _pair_before_hook)
            state = train.create_state(cfg, "cpu")
            if trainer == "fused":
                rows = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=3,
                                                **kw)
            else:
                rows, _ = train.run_epochs_es_chunked(state, graph, x, truths[1], truths[2],
                                                      epochs=3, es_window=10, **kw)
            runs.append([rows] + [p.detach().clone() for p in state.model.parameters()]
                        + [t.clone() for t in (*state.opt.m.values(), *state.opt.v.values())])
    finally:
        torch.set_num_threads(threads)
    now, before = runs
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert torch.equal(a, b)


def test_the_evaluation_halves_get_no_gradient_of_zeros(prepared, monkeypatch):
    """The blended pair's and the epilogue's backwards take the evaluation
    half's gradient as None: no [N, H] of zeros is made for it a layer."""
    _, graph, _, _ = prepared
    st, se, g, w, seeds = _epilogue_inputs()
    seen = []
    for cls in (tblend._BlendPair, tepi._Epilogue):
        real = cls.backward
        monkeypatch.setattr(cls, "backward", staticmethod(
            lambda ctx, *grads, _real=real: seen.append(grads[-1]) or _real(ctx, *grads)))
    h = st.clone().requires_grad_(True)
    s_t, s_e = tblend.blend_pair(h, se, st, se, graph, 0.9, 0.1)
    ht, _ = tepi._Epilogue.apply(s_t, w, s_e, seeds, theta(0.5, 1), 0.6, True)
    torch.autograd.grad(ht, h, g)
    assert seen == [None, None]
