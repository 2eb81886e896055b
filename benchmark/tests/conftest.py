"""CPU tests of the benchmark (``python -m pytest benchmark/tests -q``). Tests
marked ``card`` need an NVIDIA card and skip here; on the card they run with
``python3 -m pytest benchmark/tests -q -m card``."""

from __future__ import annotations

import json
import os
import shutil

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")


TINY_GRAPH = dict(num_nodes=600, num_edges=2400, num_classes=4, input_dim=40,
                  spec={"nnz_per_node": 6, "num_val": 120, "num_test": 120})


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """A copy of the benchmark's files around one tiny cell, 'tiny-cell'
    (pubmed's model on a 600-node graph), with the limits of ``cell``; the
    registry and the data cache pointed at it. Returns a function
    (backend, feature_matmul, early_stopping, cell) -> the directory."""
    from benchmark import data, registry

    def make(backend="ell", feature_matmul="dense", early_stopping=0,
             cell="pubmed-200ep"):
        root = tmp_path / f"b-{backend}-{feature_matmul}-{early_stopping}"
        for d in ("configs", "traffic", "workloads"):
            (root / d).mkdir(parents=True)
        for d in ("metrics", "families"):
            shutil.copytree(os.path.join(BENCH_DIR, d), root / d,
                            ignore=shutil.ignore_patterns("__pycache__"))
        with open(os.path.join(BENCH_DIR, "configs", "gcn2-pubmed.json")) as f:
            cfg = json.load(f)
        cfg.update(name="tiny", graphsum_backend=backend)
        cfg["graph"].update(TINY_GRAPH)
        (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
        (root / "traffic" / "t.json").write_text(json.dumps(
            {"feature_matmul": feature_matmul, "epochs": 6,
             "early_stopping": early_stopping, "trace_jobs": 2, "job_pool": 8}))
        with open(os.path.join(BENCH_DIR, "workloads", f"{cell}.json")) as f:
            limits = json.load(f)["limits"]
        (root / "workloads" / "tiny-cell.json").write_text(json.dumps(
            {"config": "tiny", "traffic": "t", "why": "a test", "limits": limits}))
        with open(os.path.join(os.path.dirname(BENCH_DIR), "BENCHMARK.json")) as f:
            bench = json.load(f)
        bench["workloads"] = [{"name": "tiny-cell", "config": "tiny", "traffic": "t",
                               "chips": 1, "why": "a test"}]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"] = ["tiny-cell"]
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        monkeypatch.setattr(registry, "BENCH_DIR", str(root))
        monkeypatch.setattr(registry, "ROOT", str(root))
        monkeypatch.setattr(data, "CACHE_DIR", str(tmp_path / "data"))
        return root

    return make


def run_tiny(capsys, trace=0, seed=2**31 + 12345, cell="tiny-cell"):
    """One run of a tiny cell on the CPU: (exit code, last stdout line as
    JSON or None, stderr)."""
    from benchmark import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                   "--trace", str(trace)], device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err
