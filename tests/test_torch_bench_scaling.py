"""The port's scaling bench (cuda_gcn_torch/bench_scaling.py) against the JAX
package's scripts/bench_scaling.py, on the CPU.

``--stats-only`` on synth-pubmed at P = 1, 2, 4 prints the JAX script's
payload exactly, and both write the same LPA label cache; the statistics of a
partition with interior tiles equal those without (the JAX script reads them
from its full local COO, which tiles do not change). ``prepare_sharded`` given
the labels lays a dataset out as it does when it computes them. A two-rank
gloo run prints the JAX script's result keys and the caveat that its times
are the host's. synth-reddit at P = 1, 2, 4, 8 against the committed
artifacts/partition_stats_reddit.json is marked slow (about 40 s). Every
test reads and writes a cache under ``tmp_path``.
"""

import json
import os
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jbench  # noqa: E402

from cuda_gcn_torch import bench as tbench  # noqa: E402
from cuda_gcn_torch import bench_scaling  # noqa: E402
from cuda_gcn_torch.config import GCNConfig  # noqa: E402
from cuda_gcn_torch.data import reorder as treorder  # noqa: E402
from cuda_gcn_torch.parallel import partition as tpart  # noqa: E402
from cuda_gcn_torch.parallel import sharded  # noqa: E402
from test_torch_train import to_torch_dataset  # noqa: E402

COMMITTED = ROOT / ".cache"
JAX_RESULT_KEYS = {"parts", "seconds", "edges_per_s", "boundary_fraction", "partition",
                   "scaling_efficiency"}


def _cache_dir(tmp_path, name, files, link=False):
    d = tmp_path / name
    d.mkdir()
    for f in files:
        (os.symlink if link else shutil.copy)(COMMITTED / f, d / f)
    return d


def _port(monkeypatch, capsys, d, argv):
    monkeypatch.setattr(tbench, "CACHE_DIR", str(d))
    assert bench_scaling.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _jax(monkeypatch, capsys, d, argv):
    monkeypatch.setattr(jbench, "CACHE_DIR", str(d))
    monkeypatch.setattr(sys, "argv", ["scripts/bench_scaling.py", *argv])
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(ROOT / "scripts" / "bench_scaling.py"), run_name="__main__")
    assert done.value.code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_stats_only_equals_the_jax_script(tmp_path, monkeypatch, capsys):
    """synth-pubmed, P = 1, 2, 4: the whole payload, and the label cache each
    writes (its name keyed on the graph and the LPA version, its labels)."""
    argv = ["--stats-only", "--dataset", "pubmed", "--parts", "1,2,4"]
    dt = _cache_dir(tmp_path, "port", ["synth-pubmed.npz"])
    dj = _cache_dir(tmp_path, "jax", ["synth-pubmed.npz"])
    got = _port(monkeypatch, capsys, dt, argv + ["--device", "cpu"])
    want = _jax(monkeypatch, capsys, dj, argv)
    assert got == want
    assert [r["parts"] for r in got["results"]] == [1, 2, 4]
    assert got["results"][2]["boundary_fraction"] > got["results"][1]["boundary_fraction"] > 0
    (lpa,) = [f for f in os.listdir(dj) if ".lpa." in f]
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    np.testing.assert_array_equal(np.load(dt / lpa), np.load(dj / lpa))


@pytest.mark.parametrize("n_parts", [2, 4])
def test_stats_do_not_depend_on_interior_tiles(tiny_dataset, n_parts):
    ds = to_torch_dataset(tiny_dataset)
    plain = tpart.partition_graph(ds.graph, n_parts)
    tiled = tpart.partition_graph(ds.graph, n_parts, interior_tiles=True, bsr_tile=16,
                                  bsr_min_edges=4)
    assert tiled.i_tile_counts.sum() > 0 and tiled.eimax < plain.eimax
    nnz = ds.graph.nnz
    assert bench_scaling.partition_stats(tiled, nnz) == bench_scaling.partition_stats(plain, nnz)


def test_prepare_sharded_with_labels_equals_without(tiny_dataset, monkeypatch):
    """Given the labels, ``prepare_sharded`` runs no label propagation and
    gives the shards it gives when it computes them."""
    ds = to_torch_dataset(tiny_dataset)
    labels = treorder.label_propagation(ds.graph.indptr, ds.graph.indices)
    cfg = GCNConfig(graphsum_backend="bsr")
    _, want, pg_want = sharded.prepare_sharded(cfg, ds, 2, bsr_tile=16, bsr_min_edges=4)
    monkeypatch.setattr(treorder, "label_propagation",
                        lambda *a, **k: pytest.fail("label propagation ran"))
    _, got, pg = sharded.prepare_sharded(cfg, ds, 2, lpa_labels=labels, bsr_tile=16,
                                         bsr_min_edges=4)
    np.testing.assert_array_equal(pg.starts, pg_want.starts)
    for a, b in zip(got, want):
        for name in ("interior", "interior_t", "boundary", "boundary_t"):
            for x, y in zip(getattr(a.part, name), getattr(b.part, name)):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.part.tile_flat, b.part.tile_flat)
        np.testing.assert_array_equal(a.x, b.x)
        for s in (1, 2, 3):
            np.testing.assert_array_equal(a.truths[s], b.truths[s])
        assert a.part.edge_capacity == b.part.edge_capacity == pg.eimax + pg.ebmax


def test_two_gloo_ranks_give_the_jax_result_keys(tmp_path, monkeypatch, capsys):
    """``--device cpu --dataset cora --parts 1,2 --epochs 2``: one gloo rank,
    then two, each timed; the JAX script's keys, and the caveat."""
    d = _cache_dir(tmp_path, "port", ["synth-cora.npz"])
    got = _port(monkeypatch, capsys, d, ["--device", "cpu", "--dataset", "cora",
                                         "--parts", "1,2", "--epochs", "2"])
    assert [r["parts"] for r in got["results"]] == [1, 2]
    for r in got["results"]:
        assert set(r) == JAX_RESULT_KEYS
        assert r["seconds"] > 0
        assert r["edges_per_s"] == pytest.approx(13_248 * 10 / r["seconds"], rel=1e-3)
    assert got["results"][0]["scaling_efficiency"] == 1.0
    assert got["device"] == "cpu" and "CPU RANKS" in got["caveat"]
    assert set(got) == {"dataset", "epochs", "platform", "n_nodes", "nnz", "results",
                        "device", "caveat"}


@pytest.mark.slow
def test_synth_reddit_stats_equal_the_committed_artifact(tmp_path, monkeypatch, capsys):
    d = _cache_dir(tmp_path, "port", ["synth-reddit.npz", "synth-reddit.lpa.724aa3bb872a.npy"],
                   link=True)
    got = _port(monkeypatch, capsys, d, ["--stats-only", "--dataset", "reddit", "--parts",
                                         "1,2,4,8", "--device", "cpu"])
    with open(ROOT / "artifacts" / "partition_stats_reddit.json") as f:
        want = json.load(f)
    assert got == want
