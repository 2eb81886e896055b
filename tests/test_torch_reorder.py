"""The port's LPA and locality permutation against the JAX package's numpy
path, and the bsr backend's default reorder='auto' through train.run.

The JAX package prefers its native C++ LPA; the tests switch it off
(``native.lpa_available``) so that its side runs numpy, while the port's side
runs its default, the native LPA (tests/test_torch_native.py holds it to the
port's numpy LPA). Labels and permutations must be equal; the training run
agrees as tests/test_torch_train.py does.
"""

import numpy as np
import pytest

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.data import native as jnative
from cuda_gcn_tpu.data import reorder as jreorder

from cuda_gcn_torch import convert
from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import reorder as treorder


@pytest.fixture(autouse=True)
def numpy_lpa(monkeypatch):
    monkeypatch.setattr(jnative, "lpa_available", lambda: False)


def random_graph(seed: int, n: int = 300, avg_deg: int = 6):
    """Undirected community graph with self-loops (4 planted clusters)."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    src = rng.integers(0, n, m)
    same = rng.random(m) < 0.8
    dst = np.where(same, (src // (n // 4)) * (n // 4) + rng.integers(0, n // 4, m),
                   rng.integers(0, n, m)) % n
    adj = [set() for _ in range(n)]
    for a, b in zip(src, dst):
        if a != b:
            adj[a].add(int(b))
            adj[b].add(int(a))
    rows = [np.concatenate([[i], sorted(adj[i])]) for i in range(n)]
    indptr = np.zeros(n + 1, np.int64)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    return tds.CSR(indptr.astype(np.int32), np.concatenate(rows).astype(np.int32))


def graphs():
    yield from (random_graph(s) for s in (0, 1))
    yield tds.load_cached("synth-pubmed").graph


@pytest.mark.parametrize("guard", [0.5, None])
@pytest.mark.parametrize("rounds", [1, 4])
def test_label_propagation_matches_jax(guard, rounds):
    for csr in graphs():
        got = treorder.label_propagation(csr.indptr, csr.indices, rounds=rounds,
                                         max_top_share=guard)
        want = jreorder.label_propagation(csr.indptr, csr.indices, rounds=rounds,
                                          prefer_native=False, max_top_share=guard)
        np.testing.assert_array_equal(got, want)


def test_collapse_guard_returns_the_previous_round():
    """A share bound below the first round's top label keeps the seed labels
    in both packages."""
    csr = random_graph(2)
    seed = np.arange(csr.nrows, dtype=np.int64)
    one = treorder.label_propagation(csr.indptr, csr.indices, rounds=1, seed_labels=seed,
                                     max_top_share=None)
    share = np.bincount(one).max() / csr.nrows
    for bound in (share * 0.99, share * 1.01):
        got = treorder.label_propagation(csr.indptr, csr.indices, rounds=3,
                                         seed_labels=seed, max_top_share=bound)
        want = jreorder.label_propagation(csr.indptr, csr.indices, rounds=3,
                                          seed_labels=seed, prefer_native=False,
                                          max_top_share=bound)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        treorder.label_propagation(csr.indptr, csr.indices, rounds=3, seed_labels=seed,
                                   max_top_share=share * 0.99), seed)


def test_cluster_order_and_locality_permutation_match_jax():
    for csr in graphs():
        perm, sizes = treorder.locality_permutation(csr, return_cluster_sizes=True)
        want_perm, want_sizes = jreorder.locality_permutation(csr, return_cluster_sizes=True)
        np.testing.assert_array_equal(perm, want_perm)
        np.testing.assert_array_equal(sizes, want_sizes)
        labels = np.random.default_rng(3).integers(0, 17, csr.nrows)
        np.testing.assert_array_equal(treorder.cluster_order(labels),
                                      jreorder.cluster_order(labels))
    assert treorder.lpa_cache_key(csr.indptr, csr.indices) == jreorder.lpa_cache_key(
        csr.indptr, csr.indices)
    assert treorder.LPA_VERSION == jreorder.LPA_VERSION


def test_bsr_run_with_default_reorder_matches_jax(tiny_dataset):
    """train.run on bsr with reorder='auto' computes the permutation, as the
    JAX prepare does, and trains to the same metrics."""
    from test_torch_train import to_torch_dataset

    cfg = JConfig(epochs=3, dropout=0.0, graphsum_backend="bsr", seed=0)
    assert cfg.reorder == "auto" and GCNConfig().reorder == "auto"
    want = jtrain.run(cfg, tiny_dataset, verbose=False)
    jstate = jtrain.create_state(tiny_dataset.apply_config(cfg))
    tcfg = GCNConfig(epochs=3, dropout=0.0, graphsum_backend="bsr", seed=0)
    tdata = to_torch_dataset(tiny_dataset)
    tcfg_, graph, x, _ = ttrain.prepare(tcfg, tdata, "cpu")
    assert graph.backend == "bsr" and graph.num_tiles > 0
    perm = jreorder.locality_permutation(tiny_dataset.graph)
    assert not np.array_equal(perm, np.arange(len(perm)))
    np.testing.assert_array_equal(x.numpy(), tds.reorder_dataset(tdata, perm).dense_features())
    state = ttrain.create_state(tcfg_, "cpu")
    state.model.load_state_dict(convert.params_from_jax(
        {k: np.asarray(v) for k, v in jstate.params.items()}, "cpu"))
    got = ttrain.run(tcfg, tdata, device="cpu", verbose=False, initial_state=state)
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    np.testing.assert_allclose([[h[k] for k in keys] for h in got.history],
                               [[h[k] for k in keys] for h in want.history],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose([got.test_loss, got.test_acc],
                               [want.test_loss, want.test_acc], rtol=1e-4, atol=1e-4)
