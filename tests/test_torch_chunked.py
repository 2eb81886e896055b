"""The port's chunked epoch runners and their CUDA graph against the JAX
package's chunked device programs, on the CPU.

The chunk policy (``_balance_chunks``, ``_estimate_epoch_seconds``,
``pick_epoch_chunk``, ``run_chunked_loop``) must cut a run where the JAX
package's cuts it: the same values on a grid of (nnz, epochs), and the same
chunk sizes and per-epoch times from a fake runner under a patched clock in
both modules. On the CPU the chunked runners run their chunks eagerly: they
must equal the eager loops bit for bit at dropout 0.5, match the JAX chunked
runners at dropout 0 within rtol 1e-4 / atol 1e-4 (tests/test_torch_train.py's
epoch tolerance), and stop early at the JAX package's epoch. ``EpochGraph``'s
bookkeeping runs against a stub of ``torch.cuda.CUDAGraph``. The CLI's
``--prime-cache``, ``--compilation-cache`` and ``--platform`` are held to the
JAX CLI's behaviour with ``--device cpu``, where priming builds the g++
libraries only.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from cuda_gcn_tpu import cli as jcli
from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig

from cuda_gcn_torch import cli as tcli
from cuda_gcn_torch import convert, graphs, kernels
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import native
from test_torch_train import to_torch_dataset

EPOCH_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_train.py:111


# -- the chunk policy -------------------------------------------------------------

def test_policy_constants_are_the_jax_packages():
    for name in ("TARGET_PROGRAM_SECONDS", "MAX_PROGRAM_SECONDS", "_PROBE_ABOVE_EST_SECONDS",
                 "_EST_SECONDS_PER_EDGE_PASS"):
        assert getattr(ttrain, name) == getattr(jtrain, name), name


@pytest.mark.parametrize("nnz", [0, 13_264, 108_365, 2_000_000, 21_000_000, 87_000_000,
                                 2_000_000_000])
@pytest.mark.parametrize("epochs", [1, 3, 7, 100, 200])
def test_chunk_sizes_match_jax(nnz, epochs):
    assert ttrain._estimate_epoch_seconds(nnz) == jtrain._estimate_epoch_seconds(nnz)
    assert ttrain.pick_epoch_chunk(nnz, epochs) == jtrain.pick_epoch_chunk(nnz, epochs)
    for raw in (0, 1, 2, 7, epochs // 3, epochs + 5):
        assert ttrain._balance_chunks(epochs, raw) == jtrain._balance_chunks(epochs, raw)


def _drive(module, monkeypatch, scenario):
    """Run ``module.run_chunked_loop`` with a fake ``run_one`` under a patched
    clock: the chunk sizes asked for, the per-epoch times, the metrics and the
    stop flag."""
    clock = {"t": 0.0}
    monkeypatch.setattr(module.time, "perf_counter", lambda: clock["t"])
    calls = []
    seconds_per_epoch, epochs, chunk, nnz, stop_after = {
        "static": (0.5, 100, None, 21_000_000, None),
        "probe": (2.0, 20, None, 2_000_000_000, None),
        "shrink": (30.0, 16, 4, 100, None),
        "given chunk": (1.0, 7, 3, 100, None),
        "stop": (1.0, 50, 10, 100, 13),
    }[scenario]
    done = {"n": 0}

    def run_one(k):
        calls.append(k)
        n = k if stop_after is None else min(k, stop_after - done["n"])
        clock["t"] += (3.0 if not calls[:-1] else 0.0) + seconds_per_epoch * n
        m = np.arange(done["n"], done["n"] + k, dtype=np.float32)
        done["n"] += n
        if stop_after is None:
            return [m + i for i in range(4)]
        return [m + i for i in range(4)], n, done["n"] == stop_after

    times = []
    metrics, stopped = module.run_chunked_loop(run_one, epochs, chunk, nnz, times_out=times)
    return calls, times, [np.asarray(v) for v in metrics], stopped


@pytest.mark.parametrize("scenario", ["static", "probe", "shrink", "given chunk", "stop"])
def test_run_chunked_loop_matches_jax(scenario, monkeypatch):
    """The static, probe and shrink paths, a given chunk and an early stop:
    the same chunk sizes and ``times_out`` as the JAX package's policy."""
    got = _drive(ttrain, monkeypatch, scenario)
    want = _drive(jtrain, monkeypatch, scenario)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    if scenario == "probe":
        assert got[0][:2] == [1, 1]
    if scenario == "shrink":
        assert max(got[0][2:]) < 4


# -- the chunked runners on the CPU -------------------------------------------------

def _prepared(tiny_dataset, backend="bsr", **cfg_kw):
    cfg = GCNConfig(graphsum_backend=backend, reorder="none", **cfg_kw)
    return ttrain.prepare(cfg, to_torch_dataset(tiny_dataset), "cpu")


def _leaves(state):
    out = {f"w.{k}": p.detach() for k, p in state.model.named_parameters()}
    out.update({f"m.{k}": t for k, t in state.opt.m.items()})
    out.update({f"v.{k}": t for k, t in state.opt.v.items()})
    out["step"] = state.opt.step
    out["generator"] = state.generator.get_state()
    return out


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


class _Cut(Exception):
    """Raised by ``_record_chunks`` once the chunk policy's arguments are read."""


def _record_chunks(module, monkeypatch, seen: list):
    """Patch ``module.run_chunked_loop`` to record, for each runner that calls
    it, the epoch measure and the chunk sizes the real policy asks for (from
    a runner that does no work), then stop the runner."""
    policy = module.run_chunked_loop

    def record(run_one, epochs, chunk, nnz, passes_per_epoch=4, times_out=None):
        ks = []
        policy(lambda k: ks.append(k) or [np.zeros(k, np.float32)] * 4, epochs, chunk, nnz,
               passes_per_epoch=passes_per_epoch)
        seen.append((nnz, ks))
        raise _Cut

    monkeypatch.setattr(module, "run_chunked_loop", record)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_sharded_chunk_measure_is_the_jax_runners(tiny_dataset, n_parts, monkeypatch):
    """The sharded runners' chunk measure on a partition with interior tiles:
    one part's padded edge capacity (eimax + ebmax, tile-covered edges left
    out) on every rank, which the JAX runners read from make_sharded_inputs'
    coefficient arrays; and with ``chunk=None`` the fused and the
    early-stopping runners of both packages ask for the same chunks. The
    policy's target is cut so that this graph's epochs make chunks of about
    seven."""
    from cuda_gcn_tpu.parallel import sharded as jsharded

    from cuda_gcn_torch.parallel import sharded as tsharded

    tiles = dict(bsr_tile=16, bsr_min_edges=4)
    mesh = jsharded.make_mesh(n_parts)
    jcfg, jin, jt = jsharded.prepare_sharded(
        tiny_dataset.apply_config(JConfig(graphsum_backend="bsr", hidden_dim=8)), tiny_dataset,
        mesh, **tiles)
    want = int(jin.interior.coef.shape[-1] + jin.boundary.coef.shape[-1])
    cfg, shards, pg = tsharded.prepare_sharded(GCNConfig(graphsum_backend="bsr", hidden_dim=8),
                                               to_torch_dataset(tiny_dataset), n_parts, **tiles)
    assert pg.i_tile_counts.min() > 0  # every part has tile-covered edges
    assert want == pg.eimax + pg.ebmax
    target = want * 4 * ttrain._EST_SECONDS_PER_EDGE_PASS * 7.5
    for module in (ttrain, jtrain):
        monkeypatch.setattr(module, "TARGET_PROGRAM_SECONDS", target)
    jax_seen, port_seen = [], []
    _record_chunks(jtrain, monkeypatch, jax_seen)
    _record_chunks(ttrain, monkeypatch, port_seen)
    with pytest.raises(_Cut):
        jsharded.run_sharded_epochs_chunked(mesh, jcfg, jtrain.create_state(jcfg), jin, jt[1],
                                            jt[2], epochs=100)
    with pytest.raises(_Cut):
        jsharded.run_sharded_epochs_es_chunked(mesh, jcfg, jtrain.create_state(jcfg), jin,
                                               jt[1], jt[2], epochs=100, es_window=4)
    assert [nnz for nnz, _ in jax_seen] == [want, want]
    for rank, shard in enumerate(shards):
        inputs = tsharded.make_sharded_inputs(
            shard.part, shard.x, "cpu", tsharded.HaloExchange(rank, n_parts, shard.part.hmax_k))
        assert inputs.edge_capacity == want
        truths = {s: tsharded.ShardedTruth(torch.from_numpy(shard.truths[s]), shard.counts[s])
                  for s in (1, 2)}
        for run, kw in ((tsharded.run_epochs_chunked, {}),
                        (tsharded.run_epochs_es_chunked, dict(es_window=4))):
            with pytest.raises(_Cut):
                run(ttrain.create_state(cfg, "cpu"), inputs, truths[1], truths[2], cfg, 100, **kw)
        assert port_seen[-2:] == jax_seen
    assert sum(jax_seen[0][1]) == 100 and 1 < len(jax_seen[0][1]) < 100


@pytest.mark.parametrize("backend", ["bsr", "ell", "segment", "dense"])
def test_cpu_chunked_equals_run_epochs(tiny_dataset, backend):
    """Chunks of 3 over 7 epochs at dropout 0.5 equal one ``run_epochs`` of 7
    bit for bit: metrics, weights, moments, step and generator; one measured
    time per epoch."""
    cfg, g, x, t = _prepared(tiny_dataset, backend)
    kw = dict(dropout_rate=0.5, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    eager = ttrain.create_state(cfg, "cpu")
    want = ttrain.run_epochs(eager, g, x, t[1], t[2], epochs=7, **kw)
    chunked = ttrain.create_state(cfg, "cpu")
    times = []
    got = ttrain.run_epochs_chunked(chunked, g, x, t[1], t[2], epochs=7, chunk=3,
                                    times_out=times, **kw)
    assert torch.equal(got, want)
    _assert_same_state(chunked, eager)
    assert len(times) == 7 and int(chunked.opt.step) == 7


@pytest.mark.parametrize("chunk", [None, 3])
def test_chunked_matches_jax_at_dropout_0(tiny_dataset, chunk):
    """The port's chunked runner against the JAX package's, from the same
    weights: metrics and final weights within rtol 1e-4 / atol 1e-4."""
    jcfg, jg, jx, jt = jtrain.prepare(JConfig(epochs=6, dropout=0.0, graphsum_backend="bsr",
                                              reorder="none"), tiny_dataset)
    kw = dict(dropout_rate=0.0, weight_decay=jcfg.weight_decay, lr=jcfg.learning_rate)
    jstate = jtrain.create_state(jcfg)
    params = {k: np.asarray(v) for k, v in jstate.params.items()}
    jstate, jm = jtrain.run_epochs_chunked(jstate, jg, jx, jt[1], jt[2], epochs=6,
                                           chunk=chunk, **kw)
    cfg, g, x, t = _prepared(tiny_dataset, dropout=0.0)
    state = ttrain.create_state(cfg, "cpu")
    state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
    got = ttrain.run_epochs_chunked(state, g, x, t[1], t[2], epochs=6, chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(m) for m in jm], 1),
                               **EPOCH_TOL)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                   **EPOCH_TOL)


ES = dict(hidden_dim=8, epochs=60, early_stopping=4, seed=0, learning_rate=0.6, dropout=0.0)


@pytest.fixture(scope="module")
def jax_es(tiny_dataset):
    """The JAX package's chunked early-stopping run (chunk 3) and its weights."""
    jcfg, jg, jx, jt = jtrain.prepare(JConfig(**ES), tiny_dataset)
    jstate = jtrain.create_state(jcfg)
    params = {k: np.asarray(v) for k, v in jstate.params.items()}
    kw = dict(dropout_rate=0.0, weight_decay=jcfg.weight_decay, lr=jcfg.learning_rate)
    _, m, stopped = jtrain.run_epochs_es_chunked(jstate, jg, jx, jt[1], jt[2],
                                                 epochs=ES["epochs"], es_window=4, chunk=3,
                                                 **kw)
    return params, np.stack(m, 1), stopped


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_es_chunked_stops_at_the_jax_epoch(tiny_dataset, jax_es, chunk):
    """``run_epochs_es_chunked`` stops where the JAX package's does, with its
    metrics, and equals the eager ``run_epochs_es`` bit for bit."""
    params, jm, jstopped = jax_es
    assert jstopped and len(jm) < ES["epochs"]
    cfg, g, x, t = _prepared(tiny_dataset, "segment", **ES)
    kw = dict(dropout_rate=0.0, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    runs = []
    for fn in (ttrain.run_epochs_es_chunked, ttrain.run_epochs_es):
        state = ttrain.create_state(cfg, "cpu")
        state.model.load_state_dict(convert.params_from_jax(params, "cpu"))
        extra = dict(chunk=chunk) if fn is ttrain.run_epochs_es_chunked else {}
        runs.append((*fn(state, g, x, t[1], t[2], epochs=ES["epochs"], es_window=4,
                         **extra, **kw), state))
    (m, stopped, state), (m_eager, stopped_eager, eager) = runs
    assert stopped and stopped_eager and len(m) == len(m_eager) == len(jm)
    np.testing.assert_allclose(m.numpy(), jm, **EPOCH_TOL)
    assert torch.equal(m, m_eager)
    _assert_same_state(state, eager)


def test_es_chunked_at_dropout_equals_eager(tiny_dataset):
    """With dropout 0.5, chunks of 2: the eager loop's stop, metrics and state."""
    cfg, g, x, t = _prepared(tiny_dataset, **dict(ES, dropout=0.5))
    kw = dict(dropout_rate=0.5, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    a, b = ttrain.create_state(cfg, "cpu"), ttrain.create_state(cfg, "cpu")
    m, stopped = ttrain.run_epochs_es_chunked(a, g, x, t[1], t[2], epochs=60, es_window=4,
                                              chunk=2, **kw)
    m_e, stopped_e = ttrain.run_epochs_es(b, g, x, t[1], t[2], epochs=60, es_window=4, **kw)
    assert stopped == stopped_e and torch.equal(m, m_e)
    _assert_same_state(a, b)


def test_run_goes_through_the_chunked_runners(tiny_dataset, monkeypatch, capsys):
    """``train.run``: more than one epoch through ``run_epochs_chunked`` with
    one measured time per epoch in the history; one epoch stepwise."""
    seen = []
    real = ttrain.run_epochs_chunked

    def spy(*a, **kw):
        seen.append(kw["epochs"])
        return real(*a, **kw)

    monkeypatch.setattr(ttrain, "run_epochs_chunked", spy)
    ds = to_torch_dataset(tiny_dataset)
    res = ttrain.run(GCNConfig(epochs=5, graphsum_backend="segment"), ds, device="cpu")
    assert seen == [5] and res.epochs_run == 5
    assert all(h["time"] > 0 for h in res.history)
    one = ttrain.run(GCNConfig(epochs=1, graphsum_backend="segment"), ds, device="cpu")
    assert seen == [5] and one.epochs_run == 1
    out = capsys.readouterr().out
    assert out.count("epoch=") == 6 and "total training time=" in out


def test_fused_rows_go_where_the_step_counter_says():
    """The row of an iteration is Adam's step counter less its start value,
    minus one, read on the device: a state resumed at step 5 fills rows 0, 1,
    2, and the trailing eval the last val metrics."""
    opt = type("Opt", (), {})()
    opt.step = torch.tensor(5, dtype=torch.int32)
    state = type("State", (), {"opt": opt, "generator": None})()

    def epoch():
        opt.step += 1
        s = opt.step.float()
        return torch.stack([s, s + 0.5, -s, -s - 0.5])

    def trailing():
        return torch.tensor(100.0), torch.tensor(200.0)

    got = ttrain.chunked_fused_epochs(epoch, trailing, state, 100, epochs=3, chunk=2,
                                      graphed=False)
    want = torch.tensor([[6, 6.5, -7, -7.5], [7, 7.5, -8, -8.5], [8, 8.5, 100, 200]])
    assert torch.equal(got, want)


# -- EpochGraph against a stub of torch.cuda.CUDAGraph ------------------------------

class _StubGraph:
    """What EpochGraph asks of torch.cuda.CUDAGraph, recorded."""

    instances: list = []
    fail_at: str | None = None

    def __init__(self):
        self.generators, self.events = [], []
        _StubGraph.instances.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def capture_begin(self):
        self.events.append("begin")
        if self.fail_at == "begin":
            raise RuntimeError("capture_begin failed")

    def capture_end(self):
        self.events.append("end")
        if self.fail_at == "end":
            raise RuntimeError("capture_end failed")

    def replay(self):
        self.events.append("replay")


@pytest.fixture
def stub_cuda_graph(monkeypatch):
    """torch.cuda.CUDAGraph as ``_StubGraph``, and the stream calls around a
    capture as no-ops."""
    _StubGraph.instances, _StubGraph.fail_at = [], None
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    return _StubGraph


def test_epoch_graph_replays_the_capture_counts(stub_cuda_graph, monkeypatch):
    """Epoch 1 runs eagerly; the capture's counts are taken back; every replay
    adds them once, to every counter dict given; the generator is registered."""
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    sent = {"rows": 0, "bytes": 0}
    calls = []

    def step():
        calls.append(len(calls))
        kernels.launches["bsr_tile"] += 4
        kernels.launches["csr_spmm"] += 4
        sent["rows"] += 10
        sent["bytes"] += 40

    gen = torch.Generator()
    eg = graphs.EpochGraph(step, (gen,), (kernels.launches, sent))
    for _ in range(6):
        eg.run()
    (g,) = stub_cuda_graph.instances
    assert calls == [0, 1]  # the eager epoch and the capture's one pass
    assert g.events == ["begin", "end"] + ["replay"] * 5 and g.generators == [gen]
    assert eg.deltas == [{"bsr_tile": 4, "csr_spmm": 4}, {"rows": 10, "bytes": 40}]
    assert kernels.launches["bsr_tile"] == kernels.launches["csr_spmm"] == 4 * 6
    assert sum(kernels.launches.values()) == 8 * 6 and sent == {"rows": 60, "bytes": 240}
    assert eg.epochs == 6


@pytest.mark.parametrize("fail_at", ["begin", "end"])
def test_a_failing_capture_raises_and_runs_nothing_eagerly(stub_cuda_graph, monkeypatch,
                                                           fail_at):
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    stub_cuda_graph.fail_at = fail_at
    calls = []

    def step():
        calls.append(1)
        kernels.launches["ell_spmm"] += 4

    eg = graphs.EpochGraph(step)
    eg.run()
    with pytest.raises(RuntimeError, match=f"capture_{fail_at} failed"):
        eg.run()
    assert len(calls) == (1 if fail_at == "begin" else 2)
    assert kernels.launches["ell_spmm"] == 4 and eg.epochs == 1 and eg.graph is None


def test_the_chunked_runner_lets_a_failing_capture_raise(stub_cuda_graph):
    """Through ``chunked_fused_epochs``: the failure reaches the caller after
    the one eager epoch, and no epoch runs eagerly in its place."""
    stub_cuda_graph.fail_at = "begin"
    opt = type("Opt", (), {})()
    opt.step = torch.tensor(0, dtype=torch.int32)
    state = type("State", (), {"opt": opt, "generator": torch.Generator()})()
    epochs = []

    def epoch():
        epochs.append(1)
        opt.step += 1
        return torch.zeros(4)

    with pytest.raises(RuntimeError, match="capture_begin failed"):
        ttrain.chunked_fused_epochs(epoch, lambda: (torch.tensor(0.0),) * 2, state, 100,
                                    epochs=5, graphed=True)
    assert len(epochs) == 1 and int(opt.step) == 1


# -- the CLI's --prime-cache, --compilation-cache and --platform ----------------------

@pytest.fixture
def build_dirs(monkeypatch):
    """Restore the libraries' directories after a test that moves them."""
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)


def test_prime_cache_builds_the_host_libraries(tmp_path, build_dirs, capsys):
    """``--prime-cache`` with ``--device cpu`` and a fresh ``--compilation-cache``:
    the three g++ libraries land there, one ``primed`` line each and the JAX
    CLI's total line, exit 0 without training, as the JAX CLI exits."""
    argv = ["synth-cora", "--prime-cache", "--epochs", "4"]
    assert jcli.main([*argv, "--platform", "cpu", "--compilation-cache", ""]) == 0
    want = capsys.readouterr().out.splitlines()
    cache = tmp_path / "libs"
    assert tcli.main([*argv, "--device", "cpu", "--compilation-cache", str(cache)]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == want[:2]  # the dataset line and "RUNNING ON CPU"
    libs = sorted(os.listdir(cache / "native"))
    assert not os.path.exists(cache / "kernels")
    assert [line.split()[1] for line in got[2:-1]] == [
        os.path.basename(native.lib_path(n)) for n in native.SOURCES]
    assert sorted(line.split()[1] for line in got[2:-1]) == libs
    assert got[-1].startswith("primed 3 programs in ") and want[-1].startswith("primed ")
    assert not any(line.startswith("epoch=") for line in got)
    # primed already: the same libraries, nothing rebuilt
    stamps = {n: os.path.getmtime(cache / "native" / n) for n in libs}
    assert tcli.main([*argv, "--platform", "cpu", "--compilation-cache", str(cache)]) == 0
    assert {n: os.path.getmtime(cache / "native" / n) for n in libs} == stamps
    assert all(line.endswith(" in 0.0s") for line in capsys.readouterr().out.splitlines()
               if line.startswith("primed lib"))


def test_prime_cache_with_mesh_exits_1_as_jax(build_dirs, capsys):
    argv = ["synth-cora", "--prime-cache", "--mesh", "2"]
    assert jcli.main([*argv, "--platform", "cpu", "--compilation-cache", ""]) == 1
    want = capsys.readouterr().err
    assert tcli.main([*argv, "--device", "cpu"]) == 1
    assert capsys.readouterr().err == want


def test_compilation_cache_is_where_the_run_builds(tmp_path, build_dirs, capsys):
    """A run with ``--compilation-cache DIR`` loads its host libraries from
    DIR/native; ``''`` gives a temporary directory."""
    assert tcli.main(["synth-cora", "--platform", "cpu", "--epochs", "2",
                      "--compilation-cache", str(tmp_path / "c")]) == 0
    assert native.BUILD_DIR == str(tmp_path / "c" / "native")
    assert kernels.BUILD_DIR == str(tmp_path / "c" / "kernels")
    assert tcli.main(["synth-cora", "--platform", "cpu", "--epochs", "2",
                      "--compilation-cache", ""]) == 0
    assert os.path.isdir(os.path.dirname(native.BUILD_DIR))
    assert os.path.dirname(native.BUILD_DIR) != str(tmp_path / "c")
    assert capsys.readouterr().out.count("epoch=2 ") == 2


def test_platform_cpu_is_device_cpu_and_tpu_exits_1(build_dirs, capsys):
    argv = ["synth-cora", "--epochs", "2", "--dropout", "0"]
    assert tcli.main([*argv, "--platform", "cpu"]) == 0
    a = capsys.readouterr().out
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    b = capsys.readouterr().out
    assert "RUNNING ON CPU" in a
    strip = [line.rsplit(" time=", 1)[0] for line in a.splitlines()]
    assert strip == [line.rsplit(" time=", 1)[0] for line in b.splitlines()]
    assert tcli.main([*argv, "--platform", "tpu"]) == 1
    assert "--platform tpu" in capsys.readouterr().err


def test_cli_takes_every_jax_flag():
    options = {s for a in jcli.build_argparser()._actions for s in a.option_strings}
    port = {s for a in tcli.build_argparser()._actions for s in a.option_strings}
    assert options <= port and {"--platform", "--compilation-cache", "--prime-cache"} <= port
    assert dataclasses.asdict(tcli.config_from_args(tcli.build_argparser().parse_args(
        ["synth-cora", "--prime-cache", "--platform", "cpu", "--compilation-cache", ""]))) \
        == dataclasses.asdict(jcli.config_from_args(jcli.build_argparser().parse_args(
            ["synth-cora", "--prime-cache", "--platform", "cpu", "--compilation-cache", ""])))
