"""The port's native host code (cuda_gcn_torch/data/native.py, native_build.py;
sources in cuda_gcn_torch/csrc/host/) against its numpy code and the JAX
package's native and numpy paths, on the same inputs: bit for bit, but for
the numpy parser's feature values (rtol 1e-6, as tests/test_native.py).

The libraries are built with g++ at first use, as they are on the card's host.
"""

import gc
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cuda_gcn_tpu.data import graph as jgraph
from cuda_gcn_tpu.data import native as jnative
from cuda_gcn_tpu.data import native_build as jnb
from cuda_gcn_tpu.data import reorder as jreorder
from cuda_gcn_tpu.data.parser import load_dataset as j_load_dataset
from cuda_gcn_tpu.data.synthetic import write_dataset

from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import graph as tgraph
from cuda_gcn_torch.data import native, native_build
from cuda_gcn_torch.data import parser as tparser
from cuda_gcn_torch.data import reorder as treorder
from test_torch_graph import asymmetric_csr, clustered, tile_bits  # noqa: F401 (a fixture)
from test_torch_reorder import random_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package builds its libraries in place into csrc/ at first use,
    and another test worker may be writing the same file at that moment; its
    modules remember a failed load, so a failure is retried for up to a minute."""
    deadline = time.monotonic() + 60
    while not (jnative.available() and jnative.lpa_available() and jnb.available()):
        if time.monotonic() > deadline:
            pytest.fail("the JAX package's native libraries do not load")
        jnative._tried = jnative._lpa_tried = jnb._tried = False
        time.sleep(1)


# --- the parser -------------------------------------------------------------

_TEXT_CASES = {  # name -> (.graph, .svmlight, .split): tests/test_native.py:28-50 and more
    "edge": ("1\n\n0 1\n", "2 0:1.5 3:2e-1\nx\n1\n", "1\n2\n3\n"),
    "neg": ("1\n0\n", "-1 0:1\n0 1:1\n", "1\n3\n"),
    "ragged": ("1 2\n\n0\n", "3 0:1 7:0.25\nnolabel 1:2\n\n0 2:1e-3", "1\n2\n\n3\n0"),
}


def _write_case(tmp_path, case, tiny_dataset):
    if case == "tiny":
        write_dataset(tiny_dataset, str(tmp_path), case)
        return
    for ext, text in zip(("graph", "svmlight", "split"), _TEXT_CASES[case]):
        (tmp_path / f"{case}.{ext}").write_text(text)


def _fields(ds):
    return {"graph.indptr": ds.graph.indptr, "graph.indices": ds.graph.indices,
            "feature_index.indptr": ds.feature_index.indptr,
            "feature_index.indices": ds.feature_index.indices,
            "feature_value": ds.feature_value, "label": ds.label, "split": ds.split,
            "dims": np.array([ds.num_nodes, ds.input_dim, ds.output_dim])}


@pytest.mark.parametrize("case", ["tiny", "edge", "neg", "ragged"])
def test_native_parser_matches_the_jax_native_parser_and_numpy(tmp_path, tiny_dataset, case, jax_native):
    """The port's native parser is the JAX package's code: the same arrays bit
    for bit, dtypes included; against the numpy parser all but the feature
    values are equal, and those within rtol 1e-6."""
    _write_case(tmp_path, case, tiny_dataset)
    got = tparser.load_dataset(case, data_dir=str(tmp_path))
    paths = {ext: str(tmp_path / f"{case}.{ext}") for ext in ("graph", "split", "svmlight")}
    jnat = jnative.load_dataset(paths)
    py = tparser.load_dataset(case, data_dir=str(tmp_path), use_native=False)
    jpy = j_load_dataset(case, data_dir=str(tmp_path), use_native=False)
    for key, arr in _fields(got).items():
        for other in (jnat, py, jpy):
            want = _fields(other)[key]
            assert arr.dtype == want.dtype, key
            if key == "feature_value" and other is not jnat:
                np.testing.assert_allclose(arr, want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(arr, want, err_msg=key)
    assert isinstance(got, tds.GCNDataset)
    if case == "edge":
        assert list(got.label) == [2, -1, 1] and (got.input_dim, got.output_dim) == (4, 3)


def test_a_file_that_cannot_be_read_raises(tmp_path):
    (tmp_path / "d.graph").mkdir()  # exists, so load_dataset reaches the parser
    for ext in ("split", "svmlight"):
        (tmp_path / f"d.{ext}").write_text("1\n")
    with pytest.raises(RuntimeError, match="native parse of .*d.graph failed"):
        tparser.load_dataset("d", data_dir=str(tmp_path))


# --- label propagation ------------------------------------------------------

def _lpa_graphs(tiny_dataset):
    return [tds.CSR(np.asarray(tiny_dataset.graph.indptr), np.asarray(tiny_dataset.graph.indices)),
            random_graph(0)]


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("rounds", [1, 4, 16])
def test_native_lpa_matches_numpy_and_jax(tiny_dataset, rounds, seeded, jax_native):
    """Fixed rounds (no guard), with and without seed labels: the native labels
    of both packages and the numpy labels of both packages, equal."""
    for csr in _lpa_graphs(tiny_dataset):
        seed = np.arange(csr.nrows, dtype=np.int64) % 7 if seeded else None
        kw = dict(rounds=rounds, seed_labels=seed, max_top_share=None)
        got = treorder.label_propagation(csr.indptr, csr.indices, **kw)
        assert got.dtype == np.int64 and got.shape == (csr.nrows,)
        for want in (treorder.label_propagation(csr.indptr, csr.indices, prefer_native=False, **kw),
                     jreorder.label_propagation(csr.indptr, csr.indices, prefer_native=False, **kw),
                     jnative.label_propagation(csr.indptr, csr.indices, rounds, seed)):
            np.testing.assert_array_equal(got, want)
        if seeded:
            np.testing.assert_array_equal(seed, np.arange(csr.nrows) % 7)  # not written to


@pytest.mark.parametrize("bound", ["default", "below", "above"])
def test_native_lpa_under_the_collapse_guard(tiny_dataset, bound):
    """The guard runs one native round at a time: the default share, and a
    bound just below / above the first round's top label."""
    csr = random_graph(2)
    seed = np.arange(csr.nrows, dtype=np.int64)
    one = treorder.label_propagation(csr.indptr, csr.indices, rounds=1, seed_labels=seed,
                                     max_top_share=None)
    share = np.bincount(one).max() / csr.nrows
    kw = {"default": {}, "below": dict(seed_labels=seed, max_top_share=share * 0.99),
          "above": dict(seed_labels=seed, max_top_share=share * 1.01)}[bound]
    for g in (csr, *(_lpa_graphs(tiny_dataset) if bound == "default" else ())):
        got = treorder.label_propagation(g.indptr, g.indices, rounds=4, **kw)
        np.testing.assert_array_equal(
            got, treorder.label_propagation(g.indptr, g.indices, rounds=4, prefer_native=False,
                                            **kw))
        np.testing.assert_array_equal(
            got, jreorder.label_propagation(g.indptr, g.indices, rounds=4, **kw))
    if bound == "below":
        np.testing.assert_array_equal(got, seed)


def test_native_lpa_refuses_bad_input():
    csr = random_graph(1)
    bad = csr.indices.copy()
    bad[3] = csr.nrows
    with pytest.raises(ValueError, match="outside"):
        native.label_propagation(csr.indptr, bad, 2)
    with pytest.raises(ValueError, match="seed labels"):
        native.label_propagation(csr.indptr, csr.indices, 2, np.zeros(3, np.int64))


# --- the build steps --------------------------------------------------------

def _coo(seed=0, n=500, m=6000, unique=False):
    """tests/test_native.py's random COO, sources sorted; optionally without
    repeated (src, dst) pairs."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, n, m))
    dst = rng.integers(0, n, m).astype(np.int64)
    if unique:
        key = np.unique(src * n + dst)
        src, dst = key // n, key % n
    counts = np.bincount(src, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, src, dst


def test_norm_coef_and_transpose_match_numpy_and_jax(jax_native):
    indptr, src, dst = _coo()
    n = len(indptr) - 1
    got = native_build.norm_coef(indptr, dst)
    deg = np.diff(indptr).astype(np.float64)
    want = (1.0 / np.sqrt(deg[src] * deg[dst])).astype(np.float32)
    assert got.dtype == np.float32
    for other in (want, jnb.norm_coef(indptr, dst)):
        np.testing.assert_array_equal(got.view(np.int32), other.view(np.int32))
    coef = np.random.default_rng(1).random(len(src)).astype(np.float32)
    got = native_build.transpose_coo(src, dst, coef, n)
    perm = np.argsort(dst, kind="stable")
    for want in ((dst[perm], src[perm], coef[perm]), jnb.transpose_coo(src, dst, coef, n)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_norm_coef_dispatch_in_graph(monkeypatch):
    """normalization_coefficients takes the native path at the threshold and
    gives numpy's bits."""
    indptr, src, dst = _coo(3)
    numpy_coef = tgraph.normalization_coefficients(indptr, dst)
    monkeypatch.setattr(tgraph, "NATIVE_BUILD_MIN_NNZ", len(dst))
    calls = []
    monkeypatch.setattr(native_build, "norm_coef",
                        lambda *a, _f=native_build.norm_coef: calls.append(1) or _f(*a))
    got = tgraph.normalization_coefficients(indptr, dst)
    assert calls == [1]
    np.testing.assert_array_equal(got.view(np.int32), numpy_coef.view(np.int32))


def test_wrapped_outputs_outlive_their_first_array():
    """A view of a wrapped output keeps the library's buffer: the buffer is
    freed only when nothing views it (4 MB, so a freed buffer is unmapped)."""
    n = 1 << 20
    indptr = np.arange(n + 1, dtype=np.int64)
    indices = np.arange(n, dtype=np.int64)[::-1].copy()
    coef = native_build.norm_coef(indptr, indices)
    tail = coef[n // 2:]
    tensor = torch.from_numpy(coef[: n // 2])
    del coef
    gc.collect()
    np.testing.assert_array_equal(tail, np.ones(n // 2, np.float32))
    assert torch.equal(tensor, torch.ones(n // 2))


def _port_tiles(src, dst, coef, n, tb, min_edges, max_tiles, dtype, unique, pair_close=False):
    """The tiles the port builds from the native selection: ids, in-tile mask,
    [k, tb, tb] tiles scattered on the CPU as build_graph does."""
    ids, rank = native_build.select_tiles(src, dst, n, tb, min_edges, max_tiles, pair_close)
    assert ids.dtype == np.int64 and rank.dtype == np.int32 and rank.shape == src.shape
    in_tile = rank >= 0
    flat = rank[in_tile].astype(np.int64) * tb * tb + (src[in_tile] % tb) * tb + dst[in_tile] % tb
    tiles = tgraph._materialize_tiles(len(ids), tb, flat, coef[in_tile],
                                      {"float32": torch.float32,
                                       "bfloat16": torch.bfloat16}[dtype], unique, "cpu")
    return ids, in_tile, tiles


@pytest.mark.parametrize("max_tiles", [10**9, 3])
@pytest.mark.parametrize("dtype,unique", [("float32", True), ("bfloat16", True),
                                          ("float32", False)])
def test_selection_builds_the_jax_native_tiles(dtype, unique, max_tiles, jax_native):
    """Through the tiles the port scatters from it, the native selection gives
    cuda_gcn_tpu.data.native_build.select_tiles's tiles, ids and residual
    mask bit for bit; the ids and ranks equal the numpy selection's."""
    indptr, src, dst = _coo(0, unique=unique)
    n, tb, min_edges = len(indptr) - 1, 16, 4
    assert unique or len(np.unique(src * n + dst)) < len(src)  # repeated edges
    coef = np.random.default_rng(1).random(len(src)).astype(np.float32)
    ids, in_tile, tiles = _port_tiles(src, dst, coef, n, tb, min_edges, max_tiles, dtype, unique)
    (j_tiles, j_rows, j_cols, j_tb, j_t), keep = jnb.select_tiles(
        src, dst, coef, n, tb, min_edges, max_tiles, jgraph._np_dtype(dtype), unique)
    assert len(ids) == len(j_rows) and (0 < len(ids) <= max_tiles)
    np.testing.assert_array_equal((ids // j_t).astype(np.int32), j_rows)
    np.testing.assert_array_equal((ids % j_t).astype(np.int32), j_cols)
    np.testing.assert_array_equal(in_tile, ~keep)
    j_bits = np.asarray(j_tiles).view(np.int16 if dtype == "bfloat16" else np.int32)
    np.testing.assert_array_equal(tile_bits(tiles), j_bits)
    # the numpy selection that build_graph runs under the threshold
    np_ids, np_rank, _ = tgraph._select_tiles(src, dst, n, tb, min_edges,
                                              max_tiles * tb * tb * (2 if dtype == "bfloat16"
                                                                     else 4),
                                              2 if dtype == "bfloat16" else 4, False)
    np.testing.assert_array_equal(ids, np_ids)
    np.testing.assert_array_equal(
        native_build.select_tiles(src, dst, n, tb, min_edges, max_tiles, False)[1], np_rank)


@pytest.mark.parametrize("max_tiles", [1, 3, 5, 10**9])
def test_pair_closed_selection_matches_numpy(max_tiles):
    """On a symmetric pattern, the native pair closure equals _pair_close after
    the numpy budget cut; every kept off-diagonal tile has its mirror."""
    indptr, src, dst = _coo(4, n=128, m=3000, unique=True)
    key = np.unique(np.concatenate([src * 128 + dst, dst * 128 + src]))
    src, dst = key // 128, key % 128
    ids, rank = native_build.select_tiles(src, dst, 128, 16, 4, max_tiles, True)
    np_ids, np_rank, t = tgraph._select_tiles(src, dst, 128, 16, 4, max_tiles * 16 * 16 * 2,
                                              2, True)
    np.testing.assert_array_equal(ids, np_ids)
    np.testing.assert_array_equal(rank, np_rank)
    kept = set(ids.tolist())
    assert all((i % t) * t + i // t in kept for i in kept)


def test_selection_refuses_bad_input():
    _, src, dst = _coo(0)
    with pytest.raises(ValueError, match="dst outside"):
        native_build.select_tiles(src, dst + 1, 500, 16, 4, 10, False)
    with pytest.raises(ValueError, match="unequal"):
        native_build.select_tiles(src, dst[1:], 500, 16, 4, 10, False)


# --- build_graph above the threshold ----------------------------------------

def _graph_arrays(g):
    out = {}
    for name in ("tiles", "tile_rows", "tile_cols", "adj"):
        t = getattr(g, name)
        if t is not None:
            out[name] = t
    for name in ("resid", "resid_t"):
        r = getattr(g, name)
        if r is not None:
            out.update({f"{name}.row_ptr": r.row_ptr, f"{name}.cols": r.cols,
                        f"{name}.coef": r.coef})
    for name in ("ell", "ell_t"):
        p = getattr(g, name)
        if p is not None:
            out.update({f"{name}.cols": p.cols, f"{name}.coef": p.coef, f"{name}.rows": p.rows})
    return out


@pytest.mark.parametrize("backend", ["bsr", "bsr-budget", "segment", "ell"])
@pytest.mark.parametrize("which", ["symmetric", "asymmetric"])
def test_build_graph_native_equals_numpy_and_jax(monkeypatch, clustered, which, backend):
    """With the threshold at 0 every build step runs natively: the graph
    equals the numpy build bit for bit, and the JAX build_graph."""
    csr = clustered.graph if which == "symmetric" else asymmetric_csr()
    kw = dict(bsr_tile=32, bsr_min_edges=8, bsr_dtype="float32") if which == "symmetric" else \
        dict(bsr_tile=16, bsr_min_edges=10, bsr_dtype="float32")
    if backend == "bsr-budget":  # a budget that cuts mirror pairs
        kw["bsr_budget_bytes"] = 3 * kw["bsr_tile"] ** 2 * 4
    tb = backend.split("-")[0]
    t_csr = tds.CSR(np.asarray(csr.indptr), np.asarray(csr.indices))
    numpy_g = tgraph.build_graph(t_csr, backend=tb, device="cpu", **kw)
    monkeypatch.setattr(tgraph, "NATIVE_BUILD_MIN_NNZ", 0)
    calls = []
    for fn in ("norm_coef", "transpose_coo", "select_tiles"):
        monkeypatch.setattr(native_build, fn, lambda *a, _f=getattr(native_build, fn), _n=fn:
                            calls.append(_n) or _f(*a))
    native_g = tgraph.build_graph(t_csr, backend=tb, device="cpu", **kw)
    want_calls = {"norm_coef"} | ({"select_tiles"} if tb == "bsr" else set()) | (
        {"transpose_coo"} if which == "asymmetric" else set())
    assert set(calls) == want_calls
    assert native_g.symmetric == numpy_g.symmetric == (which == "symmetric")
    a, b = _graph_arrays(native_g), _graph_arrays(numpy_g)
    assert a.keys() == b.keys() and len(a) >= 3
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
    if tb == "bsr":
        assert native_g.num_tiles > 0 and native_g.resid_nnz > 0
        assert native_g.num_tiles < (4 if backend == "bsr-budget" else 10**9)
        assert set(native_g.build_s) >= {"coef", "pattern", "select", "tiles", "residual"}
        jg = jgraph.build_graph(csr, backend="bsr", **kw)
        np.testing.assert_array_equal(native_g.tile_rows.numpy(), np.asarray(jg.bsr_rows))
        np.testing.assert_array_equal(native_g.tile_cols.numpy(), np.asarray(jg.bsr_cols))
        np.testing.assert_array_equal(tile_bits(native_g.tiles), np.asarray(jg.bsr_tiles).view(np.int32))
        row_ptr = native_g.resid.row_ptr.numpy().astype(np.int64)
        np.testing.assert_array_equal(np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr)),
                                      np.asarray(jg.src))
        np.testing.assert_array_equal(native_g.resid.cols.numpy(), np.asarray(jg.dst))
        np.testing.assert_array_equal(native_g.resid.coef.numpy(), np.asarray(jg.coef))


# --- no g++, a failed build, and builds that race ---------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """native builds into an empty directory, with nothing loaded yet."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_libs", {})
    return tmp_path


def _entry_calls(tmp_path, tiny_dataset, monkeypatch):
    write_dataset(tiny_dataset, str(tmp_path), "tiny")
    csr = tds.CSR(np.asarray(tiny_dataset.graph.indptr), np.asarray(tiny_dataset.graph.indices))

    def build():
        monkeypatch.setattr(tgraph, "NATIVE_BUILD_MIN_NNZ", 0)
        tgraph.build_graph(csr, backend="segment", device="cpu")

    return {"load_dataset": lambda: tparser.load_dataset("tiny", data_dir=str(tmp_path)),
            "label_propagation": lambda: treorder.label_propagation(csr.indptr, csr.indices),
            "locality_permutation": lambda: treorder.locality_permutation(csr),
            "build_graph": build}


@pytest.mark.parametrize("entry", ["load_dataset", "label_propagation", "locality_permutation",
                                   "build_graph"])
def test_without_gxx_the_native_entry_points_raise(fresh_build, tiny_dataset, monkeypatch, entry):
    """No g++ on PATH: the default paths raise, naming the way to numpy; none
    quietly takes numpy."""
    empty = fresh_build / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    call = _entry_calls(fresh_build, tiny_dataset, monkeypatch)[entry]
    with pytest.raises(RuntimeError, match=r"g\+\+ not found.*use_native=False"):
        call()
    assert not native.available() and not native.lpa_available()
    assert not os.path.exists(native.BUILD_DIR) or not os.listdir(native.BUILD_DIR)


def test_a_failed_build_raises_with_the_compiler_output(fresh_build, monkeypatch):
    src = fresh_build / "host"
    shutil.copytree(native.HOST_SRC_DIR, src)
    with open(src / "gcn_lpa.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "HOST_SRC_DIR", str(src))
    csr = random_graph(0)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for gcn_lpa.cpp(.|\n)*error"):
        treorder.label_propagation(csr.indptr, csr.indices)
    assert os.listdir(native.BUILD_DIR) == []  # no library, no temporary left


def test_an_edited_source_changes_the_library_path(fresh_build, monkeypatch):
    src = fresh_build / "host"
    shutil.copytree(native.HOST_SRC_DIR, src)
    monkeypatch.setattr(native, "HOST_SRC_DIR", str(src))
    before = {name: native.lib_path(name) for name in native.SOURCES}
    assert all(p.startswith(native.BUILD_DIR) for p in before.values())
    with open(src / "gcn_build.cpp", "a") as f:
        f.write("// edited\n")
    after = {name: native.lib_path(name) for name in native.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {"gcn_build"}


_RACE = """
import sys
import numpy as np
from cuda_gcn_torch.data import native
native.BUILD_DIR = sys.argv[1]
indptr = np.array([0, 2, 4, 6], np.int64)
indices = np.array([0, 1, 0, 1, 2, 1], np.int32)
print(native.label_propagation(indptr, indices, 4).tolist())
"""


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    out = str(tmp_path / "native")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, out], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert outs[0] == outs[1] == "[0, 0, 0]\n"
    files = os.listdir(out)
    assert len(files) == 1 and files[0].startswith("libgcn_lpa.") and files[0].endswith(".so")


def test_the_unchanged_sources_are_copies_of_the_root_ones():
    """gcn_parser.cpp and gcn_lpa.cpp are the root csrc/ files; gcn_build.cpp
    keeps their normalization and transpose as they are."""
    for name in ("gcn_parser.cpp", "gcn_lpa.cpp"):
        with open(os.path.join(ROOT, "csrc", name)) as a, \
                open(os.path.join(native.HOST_SRC_DIR, name)) as b:
            assert a.read() == b.read()
    with open(os.path.join(ROOT, "csrc", "gcn_build.cpp")) as f:
        root = f.read()
    with open(os.path.join(native.HOST_SRC_DIR, "gcn_build.cpp")) as f:
        port = f.read()
    for fn in ("int gcn_norm_coef(", "int gcn_transpose_coo("):
        body = root[root.index(fn):root.index("\n}\n", root.index(fn))]
        assert body in port
