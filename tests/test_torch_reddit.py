"""The port's GraphSAGE converter (cuda_gcn_torch/data/reddit.py) against the
JAX package's, on small hand-made dumps in the GraphSAGE format: the same
.graph/.split/.svmlight bytes and the same arrays in the .npz, read back by
the port's native and numpy parsers."""

import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from cuda_gcn_tpu.data import reddit as jreddit

from cuda_gcn_torch.data import parser as tparser
from cuda_gcn_torch.data import reddit as treddit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dumps(path, ids: str, n: int = 40, seed: int = 0):
    """GraphSAGE dumps: ``ids`` 'str' (links by id) or 'int' (links by position
    in the node list); every 7th node lacks its annotations, feature columns 2
    and 5 are constant (kept at scale 1), a few entries are exactly zero."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(n)] if ids == "str" else [1000 + 3 * i for i in range(n)]
    nodes = []
    for i, name in enumerate(names):
        role = rng.integers(0, 3)
        node = {"id": name} if i % 7 == 6 else {"id": name, "val": bool(role == 1),
                                                 "test": bool(role == 2)}
        nodes.append(node)
    pairs = rng.integers(0, n, (3 * n, 2))
    links = [{"source": names[a] if ids == "str" else int(a),
              "target": names[b] if ids == "str" else int(b)} for a, b in pairs if a != b]
    path.mkdir(parents=True, exist_ok=True)
    (path / "reddit-G.json").write_text(json.dumps({"nodes": nodes, "links": links}))
    feats = rng.normal(size=(n, 8))
    feats[:, 2] = 1.5
    feats[:, 5] = 0.0
    feats[rng.random((n, 8)) < 0.1] = 0.0
    np.save(path / "reddit-feats.npy", feats)
    order = rng.permutation(n)  # feature rows in another order than the nodes
    (path / "reddit-id_map.json").write_text(
        json.dumps({str(name): int(order[i]) for i, name in enumerate(names)}))
    (path / "reddit-class_map.json").write_text(
        json.dumps({str(name): int(rng.integers(0, 5)) for name in names}))
    return path


def _convert_both(tmp_path, ids, normalize=True):
    src = _dumps(tmp_path / "dumps", ids)
    outs = {}
    for tag, mod in (("port", treddit), ("jax", jreddit)):
        outs[tag] = mod.convert(str(src), "reddit", out_dir=str(tmp_path / tag),
                                normalize=normalize)
    return outs


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("ids", ["str", "int"])
def test_converter_writes_the_jax_packages_files(tmp_path, ids, normalize):
    outs = _convert_both(tmp_path, ids, normalize)
    for ext in ("graph", "split", "svmlight"):
        with open(os.path.join(outs["port"], f"reddit.{ext}"), "rb") as a, \
                open(os.path.join(outs["jax"], f"reddit.{ext}"), "rb") as b:
            assert a.read() == b.read(), ext
    # the .npz: the same members, each .npy byte for byte (the zip headers
    # carry the time of writing)
    with zipfile.ZipFile(os.path.join(outs["port"], "reddit.npz")) as a, \
            zipfile.ZipFile(os.path.join(outs["jax"], "reddit.npz")) as b:
        assert a.namelist() == b.namelist() == [
            "adj_indptr.npy", "adj_indices.npy", "features.npy", "label.npy", "split.npy"]
        for member in a.namelist():
            assert a.read(member) == b.read(member), member


@pytest.mark.parametrize("ids", ["str", "int"])
def test_converted_files_load_through_both_parsers(tmp_path, ids):
    out = _convert_both(tmp_path, ids)["port"]
    nat = tparser.load_dataset("reddit", data_dir=out)
    py = tparser.load_dataset("reddit", data_dir=out, use_native=False)
    z = np.load(os.path.join(out, "reddit.npz"))
    n = len(z["label"])
    assert nat.num_nodes == py.num_nodes == n == 40 - 40 // 7  # nodes lacking annotations dropped
    for a, b in ((nat.graph, py.graph), (nat.feature_index, py.feature_index)):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(nat.feature_value, py.feature_value, rtol=1e-6)
    for ds in (nat, py):
        np.testing.assert_array_equal(ds.label, z["label"])
        np.testing.assert_array_equal(ds.split, z["split"])
        # the parser puts a self-loop first in each row; the converter writes none
        deg = np.diff(ds.graph.indptr.astype(np.int64))
        np.testing.assert_array_equal(deg - 1, np.diff(z["adj_indptr"]))
        np.testing.assert_array_equal(ds.graph.indices[ds.graph.indptr[:-1]], np.arange(n))
        # features to the written precision (%.6g); zero columns are not written
        x = ds.dense_features()
        np.testing.assert_allclose(x, z["features"][:, :x.shape[1]], rtol=1e-5, atol=1e-6)
        assert not z["features"][:, x.shape[1]:].any()
    assert set(np.unique(nat.split)) <= {1, 2, 3}


def test_module_entry_point(tmp_path):
    """``python -m cuda_gcn_torch.data.reddit`` converts a directory and says where."""
    src = _dumps(tmp_path / "dumps", "str")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "cuda_gcn_torch.data.reddit", str(src),
                          "--out-dir", str(tmp_path / "out")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["Removed 5 nodes that lacked proper annotations",
                                       f"wrote reddit.graph/.split/.svmlight under {tmp_path / 'out'}"]
    jreddit.main([str(src), "--out-dir", str(tmp_path / "jax")])
    for ext in ("graph", "split", "svmlight"):
        assert (tmp_path / "out" / f"reddit.{ext}").read_bytes() == \
            (tmp_path / "jax" / f"reddit.{ext}").read_bytes()
