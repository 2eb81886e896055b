"""The port's utilities against the JAX package's (cuda_gcn_tpu/utils).

Phase timers with the same API, names and report; history files byte for
byte equal to the JAX writers'; ``grad_norm`` within rtol 1e-6; the
speed-of-light model's formula with the card's constants (a 32-byte L2 sector
as the least a row gather moves, 3,350 GB/s of HBM); and every one of the 13
phases filled by a run with ``time_ops`` on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_gcn_tpu.utils import logging as jlog
from cuda_gcn_tpu.utils import profiling as jprof
from cuda_gcn_tpu.utils import timer as jtimer

from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.utils import logging as tlog
from cuda_gcn_torch.utils import profiling as tprof
from cuda_gcn_torch.utils import timer as ttimer
from test_torch_train import to_torch_dataset

PHASES = [getattr(jtimer, n) for n in dir(jtimer) if n.startswith("TMR_")]


def test_phase_names_are_the_jax_packages():
    assert len(PHASES) == 13
    assert {n: getattr(ttimer, n) for n in dir(ttimer) if n.startswith("TMR_")} == \
        {n: getattr(jtimer, n) for n in dir(jtimer) if n.startswith("TMR_")}


def test_phase_timer_behaves_as_the_jax_one():
    """The same calls give the same totals, averages and report."""
    timers = [jtimer.PhaseTimer(), ttimer.PhaseTimer()]
    for t in timers:
        t.add("graphsum_fw", 0.012, 4)
        t.add("train", 1.5)
        t.add("graphsum_fw", 0.004)
        t.add("relu_fw", 0.25, 2)
        t.reset("relu_fw")
        t.add("test", 0.125)
    j, p = timers
    assert p.report() == j.report()
    assert p.report().splitlines()[0] == "graphsum_fw average time: 3.200ms"
    for name in ("graphsum_fw", "train", "relu_fw", "test"):
        assert p.total(name) == j.total(name)
        assert p.average_ms(name) == j.average_ms(name)
    for t in timers:
        t.start("x")
        elapsed = t.stop("x", sync=torch.zeros(1) if t is p else jnp.zeros(1))
        assert elapsed >= 0 and t.total("x") == elapsed
        t.reset()
        assert t.report() == ""


HISTORY = [dict(epoch=1, train_loss=1.9616402387619019, train_acc=0.17142857611179352,
                val_loss=1.909493327140808, val_acc=0.3019999861717224, time=0.6205),
           dict(epoch=2, train_loss=1.886458396911621, train_acc=0.3, val_loss=1.85929,
                val_acc=0.43, time=0.0123456789)]


@pytest.mark.parametrize("fmt", ["csv", "jsonl"])
def test_history_files_equal_the_jax_writers(tmp_path, fmt):
    meta = dict(dataset="synth-cora", seed=0, backend="auto", platform="CUDA",
                test_loss=1.8561960458755493, test_acc=0.417, total_train_time=1.24)
    paths = [str(tmp_path / f"{who}.{fmt}") for who in ("jax", "port")]
    for mod, path in zip((jlog, tlog), paths):
        if fmt == "csv":
            mod.write_history_csv(path, HISTORY)
        else:
            mod.write_history_jsonl(path, HISTORY, run_meta=meta)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert tlog.FIELDS == jlog.FIELDS


def test_grad_norm_equals_the_jax_one():
    rng = np.random.default_rng(3)
    arrays = {"w1": rng.standard_normal((7, 5)).astype(np.float32),
              "w2": rng.standard_normal((5, 3)).astype(np.float32)}
    want = jlog.grad_norm({k: jnp.asarray(v) for k, v in arrays.items()})
    got = tlog.grad_norm({k: torch.from_numpy(v) for k, v in arrays.items()})
    np.testing.assert_allclose(got, want, rtol=1e-6)
    bf16 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrays.items()}
    want = jlog.grad_norm({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in arrays.items()})
    np.testing.assert_allclose(tlog.grad_norm(bf16), want, rtol=1e-6)
    assert tlog.grad_norm({}) == 0.0


def test_speed_of_light_with_the_cards_constants(monkeypatch):
    """1M edges at d = 16 f32 gather 64 MB (a row is two 32-byte sectors):
    19.1 us at 3,350 GB/s; at d = 4 a 16-byte row still moves one sector. The
    formula is the JAX package's once its constants are the card's."""
    assert tprof.GATHER_TRANSACTION_BYTES == 32 and tprof.DEFAULT_HBM_GBPS == 3350.0
    r = tprof.spmm_speed_of_light(nnz=1_000_000, dim=16, measured_s=38.2e-6)
    assert r["gather_bytes"] == 64_000_000
    assert math.isclose(r["ideal_s"], 64e6 / 3.35e12) and 0.49 < r["sol_fraction"] < 0.51
    assert tprof.spmm_speed_of_light(1_000_000, 4, 1e-3)["gather_bytes"] == 32_000_000
    monkeypatch.setattr(jprof, "GATHER_TRANSACTION_BYTES", 32)
    for kw in (dict(nnz=10**6, dim=4, measured_s=1e-4),
               dict(nnz=5 * 10**6, dim=41, measured_s=2e-3, dense_tile_bytes=3 << 30,
                    residual_nnz=10**6, itemsize=2)):
        assert tprof.spmm_speed_of_light(**kw) == jprof.spmm_speed_of_light(
            **kw, hbm_gbps=3350.0)


@pytest.mark.parametrize("backend,features", [("bsr", "dense"), ("segment", "sparse"),
                                              ("pallas", "dense")])
def test_run_with_time_ops_fills_every_phase(tiny_dataset, backend, features):
    from cuda_gcn_torch.utils.timer import timers

    timers.reset()
    cfg = GCNConfig(epochs=2, graphsum_backend=backend, feature_matmul=features,
                    reorder="none", hidden_dim=8)
    res = ttrain.run(cfg, to_torch_dataset(tiny_dataset), device="cpu", verbose=False,
                     time_ops=True)
    lines = timers.report().splitlines()
    assert sorted(line.split()[0] for line in lines) == sorted(PHASES)
    for name in PHASES:
        assert math.isfinite(timers.average_ms(name)) and timers.average_ms(name) > 0
    assert timers.total("train") == res.total_train_time


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    with tprof.trace(str(tmp_path / "t")):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def test_populate_op_timers_leaves_the_run_generator_alone(tiny_dataset):
    """The per-op dropout draws come from a generator of their own."""
    cfg, graph, x, truths = ttrain.prepare(GCNConfig(hidden_dim=8),
                                           to_torch_dataset(tiny_dataset), "cpu")
    state = ttrain.create_state(cfg, "cpu")
    before = state.generator.get_state().clone()
    out = tprof.populate_op_timers(graph, x, state.params(), truths[1], cfg.seed, repeats=2)
    assert sorted(out) == sorted(set(PHASES) - {"train", "test"})
    assert torch.equal(state.generator.get_state(), before)
