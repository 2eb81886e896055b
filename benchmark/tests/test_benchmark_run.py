"""A whole run of a tiny cell on the CPU: the last line's keys, the traced
line, the import guard and the refusals."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import registry, run
from benchmark.registry import ROOT
from benchmark.tests.conftest import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line(tiny_bench, capsys):
    tiny_bench()
    rc, line, err = run_tiny(capsys)
    assert rc == 0
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "epoch_ms", "sweep_epoch_ms", "peak_mem_gib"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["checks"]) == [*registry.family("gcn").NUMBERS, "failed_jobs"]
    # the numbers and their limits are the last lines on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1].rstrip(":") for t in tail] == list(line["checks"])
    assert all("limit" in t for t in tail)


def test_traced_line(tiny_bench, capsys):
    tiny_bench(early_stopping=3)
    rc, line, _ = run_tiny(capsys, trace=1)
    assert rc == 0
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # the end-to-end metrics are not in a traced line; the per-layer ones that
    # a CPU trace can give are (no device operations: no kernel shares)
    assert "epoch_ms" not in line["metrics"]
    assert {"prepare_s", "syncs_per_epoch", "epoch_mfu"} <= set(line["metrics"])
    assert "graphsum_roofline" not in line["metrics"]


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax", "cuda_gcn_tpu.train"])
def test_import_guard(tiny_bench, capsys, monkeypatch, name):
    tiny_bench()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    rc, line, err = run_tiny(capsys)
    assert rc != 0 and line is None
    assert name.split(".")[0] in err


def test_guard_compares_whole_names(monkeypatch):
    import cuda_gcn_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    monkeypatch.setitem(sys.modules, "cuda_gcn_tpux", types.ModuleType("cuda_gcn_tpux"))
    assert run.forbidden_loaded() == []


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "reddit-dense-100ep", "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == ""
    assert "CUDA device" in err


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ (no program):
    a non-zero exit and nothing on stdout."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "pubmed-200ep", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""


def test_job_seeds_take_large_seeds():
    seeds = {run.job_seed(2**31 + 17, j) for j in range(100)}
    assert len(seeds) == 100 and max(seeds) < 2**56
    assert run.job_seed(5, 3) == run.job_seed(5, 3) != run.job_seed(6, 3)
