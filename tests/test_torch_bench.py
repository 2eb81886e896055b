"""The port's benchmark entry (cuda_gcn_torch/bench.py) against the JAX
package's (bench.py), on the CPU.

The driver's contract with a stubbed ``run_bench`` (tests/test_bench_contract.py
for the JAX entry): ONE JSON line on stdout and exit code 0, also when the run
raises, with ``value`` and ``vs_baseline`` null and the error in
``detail.error``, after exactly one attempt. ``load_bench_dataset`` and
``maybe_reorder_cached`` give the JAX functions' arrays bit for bit, read from
the committed synth-pubmed npz and permutation and generated or computed
where they are absent, and write the same files. A 3-epoch synth-cora run on
the CPU prints the JAX entry's keys (less the TPU's ``tile_engine``) with
the same metric name, backend, pass count and baseline; a bsr run on
synth-pubmed bills the graph's own tile bytes and residual edges to the
speed-of-light model. Every test reads and writes a cache under ``tmp_path``.
"""

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jbench  # noqa: E402

from cuda_gcn_torch import bench as tbench  # noqa: E402
from cuda_gcn_torch import train as ttrain  # noqa: E402
from cuda_gcn_torch.utils.profiling import spmm_speed_of_light  # noqa: E402

COMMITTED = ROOT / ".cache"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """Both entries' CACHE_DIR in a fresh directory under ``tmp_path``, holding
    copies of ``files`` from the committed cache (``cache(*files)``)."""
    def make(*files, name="cache"):
        d = tmp_path / name
        d.mkdir()
        for f in files:
            shutil.copy(COMMITTED / f, d / f)
        monkeypatch.setattr(jbench, "CACHE_DIR", str(d))
        monkeypatch.setattr(tbench, "CACHE_DIR", str(d))
        return d

    return make


def _run_main(capsys, argv):
    rc = tbench.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out  # exactly ONE line on stdout
    return rc, json.loads(out[0])


# -- the driver's contract ---------------------------------------------------------

def test_one_json_line_rc0_and_no_retry_when_the_run_fails(monkeypatch, capsys):
    calls = []

    def boom(args):
        calls.append(args)
        raise RuntimeError("synthetic kernel failure")

    monkeypatch.setattr(tbench, "run_bench", boom)
    rc, doc = _run_main(capsys, ["--epochs", "7"])
    assert rc == 0 and len(calls) == 1
    assert doc == {"metric": "reddit_7ep_train_time", "value": None, "unit": "s",
                   "vs_baseline": None,
                   "detail": {"error": "RuntimeError: synthetic kernel failure"}}


def test_a_run_that_succeeds_prints_its_result(monkeypatch, capsys):
    calls = []

    def ok(args):
        calls.append(args)
        return {"metric": "m", "value": 1.0, "unit": "s", "vs_baseline": 2.0, "detail": {}}

    monkeypatch.setattr(tbench, "run_bench", ok)
    rc, doc = _run_main(capsys, [])
    assert rc == 0 and len(calls) == 1
    assert doc == {"metric": "m", "value": 1.0, "unit": "s", "vs_baseline": 2.0, "detail": {}}
    assert (calls[0].dataset, calls[0].epochs, calls[0].device) == ("reddit", 100, "cuda")


def test_without_a_card_the_line_says_so(monkeypatch, capsys):
    """The entry runs on the card by default: without one the run raises in
    ``resolve_device`` and the line carries its error."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, doc = _run_main(capsys, ["--dataset", "cora"])
    assert rc == 0 and doc["value"] is None
    assert "CUDA device" in doc["detail"]["error"]


@pytest.mark.parametrize("times, want", [
    ([0.5] * 20, (None, 0)),
    ([0.5] * 20 + [0.01] * 20 + [0.02] * 20, (15.0, 40)),
    ([1.0] + [0.25] * 4, (250.0, 4)),
])
def test_steady_ms_leaves_out_the_first_chunk(times, want):
    ms, n = tbench.steady_ms(times)
    assert n == want[1] and (ms is None if want[0] is None else ms == pytest.approx(want[0]))


def test_device_label_is_nvidia_smis_line_for_the_card(monkeypatch):
    seen = []

    def smi(cmd, **kw):
        seen.append(cmd)
        return argparse.Namespace(stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(tbench.subprocess, "run", smi)
    assert tbench.device_label("cpu") == "cpu" and not seen
    assert tbench.device_label("cuda:1") == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen == [["nvidia-smi", "--id=1", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]]


# -- the dataset and its permutation -----------------------------------------------

FIELDS = ("feature_value", "label", "split", "num_nodes", "input_dim", "output_dim")


def assert_datasets_equal(t, j):
    for csr in ("graph", "feature_index"):
        for arr in ("indptr", "indices"):
            a, b = getattr(getattr(t, csr), arr), np.asarray(getattr(getattr(j, csr), arr))
            assert a.dtype == b.dtype, (csr, arr)
            np.testing.assert_array_equal(a, b)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("name, cached", [("pubmed", True), ("cora", False)])
def test_load_bench_dataset_and_reorder_equal_jax(cache, tmp_path, name, cached):
    """Committed synth-pubmed npz and permutation, read; synth-cora,
    generated and its permutation computed: the same arrays as the JAX
    functions', and the same files written."""
    files = (f"synth-{name}.npz", f"synth-{name}.perm.npy") if cached else ()
    d = cache(*files)
    t, tname = tbench.load_bench_dataset(name, str(tmp_path / "no-data"))
    written = {f: np.load(d / f) for f in os.listdir(d)}
    for f in os.listdir(d):
        if not cached:
            os.remove(d / f)
    j, jname = jbench.load_bench_dataset(name, str(tmp_path / "no-data"))
    assert tname == jname == f"synth-{name}"
    assert_datasets_equal(t, j)
    tr = tbench.maybe_reorder_cached(t, tname)
    if not cached:
        written[f"synth-{name}.perm.npy"] = np.load(d / f"synth-{name}.perm.npy")
        os.remove(d / f"synth-{name}.perm.npy")
    jr = jbench.maybe_reorder_cached(j, jname)
    assert_datasets_equal(tr, jr)
    assert sorted(os.listdir(d)) == sorted(written) == sorted(
        [f"synth-{name}.npz", f"synth-{name}.perm.npy"])
    for f, got in written.items():  # the port wrote what the JAX entry writes
        want = np.load(d / f)
        if f.endswith(".npz"):
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got, want)


# -- whole runs on the CPU ---------------------------------------------------------

def test_cpu_run_prints_the_jax_entrys_keys(cache, tmp_path, capsys):
    """``--device cpu --dataset cora --epochs 3`` against the JAX
    ``bench.run_bench`` on the same arguments (no persistent XLA cache)."""
    cache("synth-cora.npz")
    data_dir = str(tmp_path / "no-data")
    rc, doc = _run_main(capsys, ["--device", "cpu", "--dataset", "cora", "--epochs", "3",
                                 "--data-dir", data_dir])
    assert rc == 0 and "error" not in doc["detail"], doc
    want = jbench.run_bench(argparse.Namespace(
        dataset="cora", epochs=3, backend="auto", compute_dtype="float32",
        feature_matmul="dense", bsr_budget_gb=None, data_dir=data_dir, compilation_cache=""))
    assert sorted(doc) == sorted(want)
    assert sorted(doc["detail"]) == sorted(k for k in want["detail"] if k != "tile_engine")
    assert doc["metric"] == want["metric"] == "synth-cora_3ep_train_time"
    for k in ("backend", "executed_passes_min", "baseline_cuda_s", "feature_matmul"):
        assert doc["detail"][k] == want["detail"][k], k
    assert doc["detail"]["device"] == "cpu"
    assert doc["value"] > 0 and np.isfinite(doc["detail"]["test_acc"])


def test_bsr_run_bills_the_graphs_own_tiles_and_residual(cache, tmp_path, capsys,
                                                         monkeypatch):
    """A bsr run on synth-pubmed (its committed permutation): the ideal
    seconds a pass equal ``spmm_speed_of_light`` over the tiles' bytes and the
    residual edges of the graph the run built, at pass width 2 · 16."""
    cache("synth-pubmed.npz", "synth-pubmed.perm.npy")
    built = []
    prepare = ttrain.prepare

    def keep(*a, **k):
        out = prepare(*a, **k)
        built.append(out[1])
        return out

    monkeypatch.setattr(ttrain, "prepare", keep)
    rc, doc = _run_main(capsys, ["--device", "cpu", "--dataset", "pubmed", "--epochs", "2",
                                 "--backend", "bsr", "--data-dir", str(tmp_path / "no-data")])
    assert rc == 0 and doc["detail"]["backend"] == "bsr", doc
    (graph,) = built
    assert graph.num_tiles > 0 and graph.resid_nnz > 0
    sol = spmm_speed_of_light(107_879, 32, 1.0,
                              dense_tile_bytes=graph.num_tiles * 256 * 256 * 2,
                              residual_nnz=graph.resid_nnz)
    assert doc["detail"]["sol_ideal_s_per_pass"] == round(sol["ideal_s"], 6)
    assert doc["detail"]["executed_passes_min"] == 10
    assert doc["metric"] == "synth-pubmed_2ep_train_time"
    assert sorted(os.listdir(tmp_path / "cache")) == ["synth-pubmed.npz",
                                                      "synth-pubmed.perm.npy"]
