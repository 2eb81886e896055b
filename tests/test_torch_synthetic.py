"""The port's synthetic datasets (cuda_gcn_torch/data/synthetic.py) against the
JAX package's generator, and the CLI that now follows ``--seed``.

The same name or spec and seed must give the same arrays, bit for bit and of
the same types, as ``cuda_gcn_tpu.data.synthetic.make_synthetic``; seed 0 must
give the tracked ``.cache`` files, which the CLI may read in its place. No
reddit-size profile is generated here: their specs are compared field by
field, and their knobs are exercised on a small spec.
"""

import dataclasses
import os

import numpy as np
import pytest

from cuda_gcn_tpu.data import synthetic as jsyn

from cuda_gcn_torch import cli
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import parser as tparser
from cuda_gcn_torch.data import synthetic as tsyn

SMALL = dict(num_nodes=300, num_edges=900, num_classes=5, input_dim=40, nnz_per_node=7,
             train_per_class=8, num_val=50, num_test=80)


def assert_same_dataset(got, want):
    """Every array equal and of the same type, every dim equal."""
    for name in ("graph", "feature_index"):
        g, w = getattr(got, name), getattr(want, name)
        for field in ("indptr", "indices"):
            a, b = np.asarray(getattr(g, field)), np.asarray(getattr(w, field))
            assert a.dtype == b.dtype, (name, field)
            np.testing.assert_array_equal(a, b)
    for name in ("feature_value", "label", "split"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    for name in ("num_nodes", "input_dim", "output_dim"):
        assert getattr(got, name) == getattr(want, name)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_small_spec_equals_jax_at_three_seeds(seed):
    got = tsyn.make_synthetic(tsyn.SynthSpec(**SMALL), seed=seed)
    assert isinstance(got, tds.GCNDataset)
    assert_same_dataset(got, jsyn.make_synthetic(jsyn.SynthSpec(**SMALL), seed=seed))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", ["synth-cora", "synth-citeseer"])
def test_named_profiles_equal_jax(name, seed):
    assert_same_dataset(tsyn.make_synthetic(name, seed=seed),
                        jsyn.make_synthetic(name, seed=seed))


@pytest.mark.parametrize("name", sorted(jsyn.PROFILES) + sorted(jsyn.VARIANTS))
def test_spec_of_every_profile_and_variant_equals_jax(name):
    """The spec fields only: the reddit-size profiles are not generated."""
    assert dataclasses.asdict(tsyn.spec_for(name)) == dataclasses.asdict(jsyn.spec_for(name))
    assert tsyn.PROFILES.get(name) == jsyn.PROFILES.get(name)


def test_the_tables_equal_jax():
    assert tsyn.PROFILES == jsyn.PROFILES and tsyn.VARIANTS == jsyn.VARIANTS
    assert [f.name for f in dataclasses.fields(tsyn.SynthSpec)] == \
        [f.name for f in dataclasses.fields(jsyn.SynthSpec)]


@pytest.mark.parametrize("name", sorted(jsyn.VARIANTS) + ["synth-reddit"])
def test_generation_with_a_profiles_knobs_on_a_small_spec(name):
    """The difficulty knobs of a reddit-size spec (band, noise, label noise)
    on a small graph: the same arrays."""
    spec = jsyn.spec_for(name)
    knobs = {k: getattr(spec, k) for k in ("feat_band_p", "feat_noise", "label_noise",
                                           "homophily", "powerlaw")}
    got = tsyn.make_synthetic(tsyn.SynthSpec(**SMALL, **knobs), seed=2)
    assert_same_dataset(got, jsyn.make_synthetic(jsyn.SynthSpec(**SMALL, **knobs), seed=2))


@pytest.mark.parametrize("name", ["synth-cora", "synth-citeseer", "synth-pubmed"])
def test_seed_0_equals_the_tracked_cache(name):
    """What the CLI reads at seed 0 is what it would generate."""
    assert os.path.exists(os.path.join(tds.CACHE_DIR, f"{name}.npz"))
    assert_same_dataset(tsyn.make_synthetic(name, seed=0), tds.load_cached(name))


def test_write_dataset_round_trips_through_the_parser(tmp_path):
    ds = tsyn.make_synthetic(tsyn.SynthSpec(**SMALL), seed=4)
    tsyn.write_dataset(ds, str(tmp_path), "small")
    back = tparser.load_dataset("small", data_dir=str(tmp_path))
    for name in ("graph", "feature_index"):
        np.testing.assert_array_equal(getattr(back, name).indptr, getattr(ds, name).indptr)
        np.testing.assert_array_equal(getattr(back, name).indices, getattr(ds, name).indices)
    np.testing.assert_allclose(back.feature_value, ds.feature_value, rtol=1e-5)
    np.testing.assert_array_equal(back.label, ds.label)
    np.testing.assert_array_equal(back.split, ds.split)
    assert (back.num_nodes, back.output_dim) == (ds.num_nodes, ds.output_dim)


@pytest.fixture
def seen_runs(monkeypatch):
    """Records (cfg, dataset) of every ``train.run`` the CLI makes, then runs it."""
    seen, real = [], ttrain.run

    def run(cfg, dataset, **kw):
        seen.append((cfg, dataset))
        return real(cfg, dataset, **kw)

    monkeypatch.setattr(ttrain, "run", run)
    return seen


def test_cli_generates_the_seeded_graph(capsys, seen_runs):
    """synth-cora at seed 3 is generated with that seed, as the JAX CLI does
    (cuda_gcn_tpu/cli.py:114-118), and trained in the output contract."""
    assert cli.main(["synth-cora", "--seed", "3", "--epochs", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:2] == ["Generated synthetic dataset synth-cora.", "RUNNING ON CPU"]
    assert lines[3].startswith("epoch=2 ") and lines[-1].startswith("test_loss=")
    (cfg, dataset), = seen_runs
    assert cfg.seed == 3 and cfg.compute_dtype == "float32"
    assert_same_dataset(dataset, jsyn.make_synthetic("synth-cora", seed=3))
    # seed 0 reads the cache, which is the generator's seed-0 output
    assert cli.main(["synth-cora", "--epochs", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("Generated synthetic dataset synth-cora.\n")
    assert_same_dataset(seen_runs[1][1], jsyn.make_synthetic("synth-cora", seed=0))


@pytest.mark.parametrize("seed", [0, 3])
def test_cached_permutation_only_for_the_cached_graph(monkeypatch, seed):
    """bsr relabels with ``.cache/synth-pubmed.perm.npy`` only the cached
    seed-0 graph; a graph of another seed goes through the locality
    permutation that train.prepare computes (reorder 'auto')."""
    seen = []
    monkeypatch.setattr(ttrain, "run", lambda cfg, dataset, **kw: seen.append((cfg, dataset)))
    assert cli.main(["synth-pubmed", "--backend", "bsr", "--seed", str(seed), "--device",
                     "cpu"]) == 0
    (cfg, dataset), = seen
    raw = jsyn.make_synthetic("synth-pubmed", seed=seed)
    if seed == 0:
        assert cfg.reorder == "none"
        assert_same_dataset(dataset, tds.reorder_cached(tds.load_cached("synth-pubmed"),
                                                        "synth-pubmed"))
    else:
        assert cfg.reorder == "auto"
        assert_same_dataset(dataset, raw)


def test_cli_takes_the_compute_dtype_and_sends_other_names_to_the_parser(
        tmp_path, capsys, seen_runs):
    assert cli.main(["synth-cora", "--seed", "1", "--epochs", "1", "--device", "cpu",
                     "--compute-dtype", "bfloat16"]) == 0
    assert seen_runs[0][0].compute_dtype == "bfloat16"
    assert "test_loss=" in capsys.readouterr().out
    # a synth-* name that is no profile is a file name, as in the JAX CLI
    assert cli.main(["synth-nothing", "--data-dir", str(tmp_path), "--device", "cpu"]) == 1
    assert "Cannot read input: synth-nothing" in capsys.readouterr().err
