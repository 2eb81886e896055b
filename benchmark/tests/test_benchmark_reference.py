"""The gcn family's reference against the program on tiny graphs on the CPU,
its gradients against autograd, TF32 rounding, and its imports."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, reference, registry, synth
from benchmark.registry import ROOT
from benchmark.run import job_seed

gcn = registry.family("gcn")


def _tiny(seed=0, n=500, e=2500):
    return synth.make_synthetic(synth.spec_for(n, e, 4, 32, nnz_per_node=6, num_val=n // 5,
                                                    num_test=n // 5), seed=seed)


MODEL = {"hidden_dim": 16, "dropout": 0.5, "learning_rate": 0.01, "weight_decay": 5e-4}


def _readings(backend, feature_matmul="dense", es=0, dropout=MODEL["dropout"]):
    """(program, reference) readings of the first three steps on a tiny graph,
    the reference applying the program's dropout masks."""
    d = _tiny()
    cfg = _config(backend, dropout)
    traffic = {"feature_matmul": feature_matmul, "epochs": 20, "early_stopping": es}
    prep = gcn.prepare(cfg, traffic, d, "cpu")
    seed = job_seed(2**31 + 7, "check")
    got = gcn.check_steps(prep, d, seed)
    return got, gcn.follow(gcn.reference_inputs(d, cfg, traffic, "cpu"), cfg, seed, got)


def _config(backend="ell", dropout=MODEL["dropout"]):
    return {"model": dict(MODEL, dropout=dropout), "graphsum_backend": backend,
            "compute_dtype": "float32", "param_dtype": "float32"}


@pytest.mark.parametrize("backend,feature_matmul,es", [
    ("ell", "dense", 0), ("segment", "dense", 0), ("ell", "sparse", 0), ("ell", "dense", 10)])
def test_reference_follows_the_program(backend, feature_matmul, es):
    """The program's first three steps (program.check_steps, the window's own
    calls, dropout 0.5) against the reference with the masks read back:
    backends with float32 edge coefficients agree to float32 rounding, and
    the masks read as independent draws that keep half."""
    got, ref = _readings(backend, feature_matmul, es)
    values = gcn.numbers(got, ref)
    assert max(v for k, v in values.items() if k != "mask_z") < 2e-5, values
    assert values["mask_z"] < 5, values
    assert len(got.masks) == 3 and got.train_loss[2] < got.train_loss[0]
    for x_kept, hidden_kept in got.masks:
        assert 0.3 < float(x_kept.float().mean()) < 0.7
        assert 0.1 < float(hidden_kept.float().mean()) < 0.4  # half of the positive half


@pytest.mark.parametrize("feature_matmul,es", [("dense", 0), ("sparse", 10)])
def test_bsr_reads_its_bf16_tiles(feature_matmul, es):
    """The witness of PERF.md's open question: at compute float32 the bsr
    build rounds its tiles' coefficients to bf16, and its first gradient
    reads that far from the float32 reference (ell reads float32 rounding).
    Without dropout, since bsr relabels the nodes and a mask read back would
    lie in the program's order."""
    bsr = gcn.numbers(*_readings("bsr", feature_matmul, es, dropout=0.0))
    ell = gcn.numbers(*_readings("ell", feature_matmul, es, dropout=0.0))
    assert bsr["grad1_diff"] > 1e-4 > 1e2 * ell["grad1_diff"]


@pytest.mark.parametrize("fault", ["dropout_skipped", "hidden_dropout_skipped",
                                   "dropout_unscaled", "dropout_rate", "grad0_scaled"])
def test_reference_faults_read_apart(fault):
    """The reference in the program's place with a dropout or first-layer
    fault planted reads far from the sound reference: on the masks, on the
    losses, on the first layer's gradient."""
    got, ref = _readings("ell")
    cfg = _config()
    inputs = gcn.reference_inputs(_tiny(), cfg, {"feature_matmul": "dense"}, "cpu")
    bad = gcn.numbers(gcn.follow(inputs, cfg, job_seed(2**31 + 7, "check"), got, fault=fault),
                      ref)
    key = {"dropout_skipped": "mask_z", "hidden_dropout_skipped": "mask_z",
           "dropout_unscaled": "loss_gap", "dropout_rate": "mask_z",
           "grad0_scaled": "grad1_l0_gap"}[fault]
    # a rate 0.05 off reads 0.1·sqrt(n) deviations: about 6 on the 3,000 nnz here
    floor = 4 if fault == "dropout_rate" else {"mask_z": 30, "loss_gap": 1e-3,
                                                "grad1_l0_gap": 0.09}[key]
    assert bad[key] > floor, bad


@pytest.mark.parametrize("hidden", [(8,), (8, 6)])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_reference_gradients_are_autograds(dropout, hidden):
    """The hand-written gradients of every layer against autograd in float64,
    at one hidden layer and at two."""
    d = _tiny(n=120, e=400)
    prob = gcn.build_problem(d, hidden, "dense", "cpu")
    gen = torch.Generator().manual_seed(5)
    keep = 1.0 - dropout
    kept = torch.rand(len(prob.f_values), generator=gen) < keep
    hidden_kept = tuple(torch.rand(120, h, generator=gen) < keep for h in hidden)
    x_drop = prob.features(torch.where(kept, prob.f_values / keep, 0.0))[0]
    drop = gcn.Dropout(x_drop, None, hidden_kept, keep) if dropout else None
    w = [t.double().requires_grad_() for t in reference.glorot_weights(prob.dims, 3)]
    adj = prob.adj.to_dense().double()
    h = (x_drop if dropout else prob.x).double()
    for i, wi in enumerate(w[:-1]):
        h = torch.relu(adj @ (h @ wi))
        h = h * hidden_kept[i] / keep if dropout else h
    logits = adj @ (h @ w[-1])
    truth = prob.truth[1]
    mask = truth >= 0
    ce = torch.nn.functional.cross_entropy(logits[mask], truth[mask])
    want = ce + 0.5 * 5e-4 * (w[0] ** 2).sum()
    want.backward()
    model = gcn.Model(prob, 5e-4)
    loss, grads, _ = model.gradients([t.detach().float() for t in w], truth, drop)
    assert abs(float(loss) - float(want.detach())) < 1e-5
    assert len(grads) == len(w)
    for g, wi in zip(grads, w):
        assert torch.allclose(g.double(), wi.grad, rtol=1e-4, atol=1e-7)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-11,
                      3.14159265], dtype=torch.float32)
    got = reference.round_tf32(x)
    want = [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0, 3.140625]
    assert got.tolist() == want
    assert np.all(np.abs(got.numpy() - x.numpy()) <= np.abs(x.numpy()) * 2**-11)


def test_reference_imports_nothing_of_the_program():
    """The generic modules, and the gcn family's reference run through its
    steps and comparison, load nothing of the program or of JAX."""
    code = ("import sys, torch; import benchmark.reference, benchmark.compare, "
            "benchmark.roofline, benchmark.synth, benchmark.trace, benchmark.data, "
            "benchmark.registry as r; gcn = r.family('gcn'); "
            "d = benchmark.synth.make_synthetic(benchmark.synth.spec_for(60, 150, 3, 8, "
            "nnz_per_node=3, num_val=10, num_test=10), seed=0); "
            "cfg = {'model': {'hidden_dims': [8, 4], 'dropout': 0.5, 'learning_rate': 0.01, "
            "'weight_decay': 5e-4}}; g = torch.Generator().manual_seed(0); "
            "masks = [(torch.rand(len(d['f_values']), generator=g) >= 0.5, "
            "torch.rand(60, 8, generator=g) >= 0.5, torch.rand(60, 4, generator=g) >= 0.5)] * 3; "
            "inputs = gcn.reference_inputs(d, cfg, {'feature_matmul': 'sparse'}, 'cpu'); "
            "ref = gcn.follow(inputs, cfg, 1, gcn.Readings([], [], 0.0, [], [], masks=masks)); "
            "gcn.numbers(ref, ref); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cuda_gcn_torch', 'cuda_gcn_tpu', 'jax', 'jaxlib', 'flax'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_a_non_finite_reading_reads_infinite():
    ones = [torch.ones(4, 2), torch.ones(2, 3)]
    ref = gcn.Readings([1.0] * 3, [1.0] * 3, 1.0, ones, ones)
    nan = [torch.ones(4, 2), torch.full((2, 3), float("nan"))]
    prog = gcn.Readings([float("nan"), 1.0, 1.0], [1.0] * 3, 1.0, nan, ones)
    values = gcn.numbers(prog, ref)
    assert values["loss_gap"] == values["grad1_gap"] == values["grad1_diff"] == float("inf")
    assert gcn.numbers(ref, ref) == dict.fromkeys(gcn.NUMBERS, 0.0)
    assert not compare.judge(values, dict.fromkeys(gcn.NUMBERS, 1.0))


def test_judge_refuses_other_numbers():
    with pytest.raises(ValueError, match="other"):
        compare.judge({"a": 0.0}, {"a": 1.0, "other": 1.0})
