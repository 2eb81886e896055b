"""The port's spans (cuda_gcn_torch/utils/profiling.py ``span``) on the CPU.

With no profiler recording, ``span`` enters no ``record_function``. Under
``profiling.trace`` the chunked runners write ``train.epochs`` with their
chunk reads and their trailing evaluation (the fused loop) or stop-flag reads
(the early-stopping loop) inside it, and ``EpochGraph``, against the stub of
``torch.cuda.CUDAGraph`` in tests/test_torch_chunked.py, one ``graphs.eager``
and then one ``graphs.capture``. Tracing changes no metric row, launch count or
dropout draw.
"""

import json

import pytest
import torch

from cuda_gcn_torch import graphs, kernels
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.utils import profiling
from test_torch_chunked import _assert_same_state
from test_torch_chunked import stub_cuda_graph  # noqa: F401  (a fixture)
from test_torch_train import to_torch_dataset

RUNNERS = ["fused", "es"]


@pytest.fixture(scope="module")
def prepared(tiny_dataset):
    cfg = GCNConfig(graphsum_backend="segment", reorder="none", hidden_dim=8, dropout=0.5)
    return ttrain.prepare(cfg, to_torch_dataset(tiny_dataset), "cpu")


def _train(prepared, runner):
    """A fresh state trained by ``runner`` in chunks: (state, metrics)."""
    cfg, g, x, t = prepared
    state = ttrain.create_state(cfg, "cpu")
    kw = dict(dropout_rate=0.5, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    if runner == "fused":
        m = ttrain.run_epochs_chunked(state, g, x, t[1], t[2], epochs=5, chunk=2, **kw)
    else:
        m, _ = ttrain.run_epochs_es_chunked(state, g, x, t[1], t[2], epochs=5, es_window=3,
                                            chunk=2, **kw)
    return state, m


def _spans(logdir) -> list[tuple[str, float, float]]:
    """(name, start, end) of the trace's user annotations, in order of start."""
    with open(logdir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    return sorted(out, key=lambda t: t[1])


def _named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _graph_epochs(epochs: int):
    """An ``EpochGraph`` run for ``epochs`` epochs of a step that counts 4
    launches: (the graph, one entry per call of the step)."""
    step_calls = []

    def step():
        step_calls.append(1)
        kernels.launches["ell_spmm"] += 4

    eg = graphs.EpochGraph(step)
    for _ in range(epochs):
        eg.run()
    return eg, step_calls


@pytest.mark.parametrize("what", ["span", *RUNNERS, "graph"])
def test_no_profiler_no_record_function(what, prepared, stub_cuda_graph, monkeypatch):
    """With no profiler session, neither ``span`` nor the runners and
    ``EpochGraph`` that open spans construct a ``record_function``."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    if what == "span":
        with profiling.span("a.span"):
            pass
    elif what == "graph":
        monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
        _graph_epochs(3)
    else:
        _train(prepared, what)


@pytest.mark.parametrize("runner", RUNNERS)
def test_chunked_runners_write_their_spans(runner, prepared, tmp_path):
    """One ``train.epochs`` a run, a ``train.chunk_read`` a chunk inside it,
    and the fused loop's ``train.trailing_eval`` (with its ``train.eval``) or
    the early-stopping loop's ``train.stop_flag`` an epoch, inside it too."""
    with profiling.trace(str(tmp_path / "t")):
        _, m = _train(prepared, runner)
    spans = _spans(tmp_path / "t")
    (create,) = _named(spans, "train.create_state")
    (loop,) = _named(spans, "train.epochs")
    assert create[1] <= loop[0]
    reads = _named(spans, "train.chunk_read")
    assert len(reads) == -(-len(m) // 2) and all(_inside(r, loop) for r in reads)
    if runner == "fused":
        (trailing,) = _named(spans, "train.trailing_eval")
        assert _inside(trailing, loop) and trailing[0] >= reads[-1][1]
        (ev,) = _named(spans, "train.eval")
        assert _inside(ev, trailing)
        assert not _named(spans, "train.stop_flag")
    else:
        flags = _named(spans, "train.stop_flag")
        assert len(flags) == len(m) and all(_inside(f, loop) for f in flags)
        assert not _named(spans, "train.trailing_eval")
        # each epoch's eval, inside the loop
        assert len(_named(spans, "train.eval")) == len(m)
    assert not _named(spans, "graphs.eager") and not _named(spans, "graphs.capture")


def test_epoch_graph_writes_eager_then_capture(stub_cuda_graph, monkeypatch, tmp_path):
    """Three epochs: one ``graphs.eager``, then one ``graphs.capture`` (the
    capture's one pass of the step inside it), and no span for the replay."""
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    with profiling.trace(str(tmp_path / "t")):
        eg, calls = _graph_epochs(3)
    spans = _spans(tmp_path / "t")
    assert [n for n, _, _ in spans] == ["graphs.eager", "graphs.capture"]
    (eager,), (capture,) = _named(spans, "graphs.eager"), _named(spans, "graphs.capture")
    assert eager[1] <= capture[0]
    assert len(calls) == 2
    assert stub_cuda_graph.instances[0].events == ["begin", "end", "replay", "replay"]
    assert eg.epochs == 3 and kernels.launches["ell_spmm"] == 12


@pytest.mark.parametrize("runner", RUNNERS)
def test_tracing_changes_no_row_or_draw(runner, prepared, monkeypatch, tmp_path):
    """The same run with the profiler on and off: rows, weights, moments,
    step and the dropout generator's state bit for bit, and the same launch
    counts."""
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    off_state, off_rows = _train(prepared, runner)
    off_launches = dict(kernels.launches)
    monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
    with profiling.trace(str(tmp_path / "t")):
        on_state, on_rows = _train(prepared, runner)
    assert torch.equal(on_rows, off_rows) and dict(kernels.launches) == off_launches
    _assert_same_state(on_state, off_state)


def test_tracing_changes_no_graph_count(stub_cuda_graph, monkeypatch, tmp_path):
    """``EpochGraph``'s counters after a capture and replays read the same
    with the profiler on and off."""
    got = []
    for traced in (False, True):
        monkeypatch.setattr(kernels, "launches", dict.fromkeys(kernels.launches, 0))
        if traced:
            with profiling.trace(str(tmp_path / "t")):
                eg, _ = _graph_epochs(5)
        else:
            eg, _ = _graph_epochs(5)
        got.append((dict(kernels.launches), eg.deltas))
    assert got[0] == got[1] and got[0][0]["ell_spmm"] == 20
