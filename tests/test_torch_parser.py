"""The port's text parser against the format's semantics (src/common/parser.cpp)
and against the JAX package's parser on the same files.

The cases of tests/test_parser.py run on the port's parser; then both parsers
read the same ``.graph``/``.split``/``.svmlight`` files and must give equal
arrays, exactly (both are numpy and parse the same text).
"""

import dataclasses

import numpy as np
import pytest

from cuda_gcn_tpu.data import parser as jparser
from cuda_gcn_tpu.data.synthetic import write_dataset

from cuda_gcn_torch import cli
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data import parser as tparser


def test_graph_self_loop_prepended():
    csr = tparser.parse_graph_text(["1 2", "0", "0 1"])
    assert list(csr.indptr) == [0, 3, 5, 8]
    assert list(csr.indices) == [0, 1, 2, 1, 0, 2, 0, 1]
    assert csr.nrows == 3 and isinstance(csr, tds.CSR)
    assert csr.indptr.dtype == csr.indices.dtype == np.int32


def test_graph_empty_line_is_isolated_node():
    csr = tparser.parse_graph_text(["", "0"])
    assert list(csr.indptr) == [0, 1, 3]
    assert list(csr.indices) == [0, 1, 0]


def test_svmlight_basic():
    csr, vals, labels, input_dim, output_dim = tparser.parse_svmlight_text(
        ["2 0:1.5 3:2.0", "0 1:0.5", "1"])
    assert list(csr.indptr) == [0, 2, 3, 3]
    assert list(csr.indices) == [0, 3, 1]
    np.testing.assert_allclose(vals, [1.5, 2.0, 0.5])
    assert vals.dtype == np.float32
    assert list(labels) == [2, 0, 1]
    assert input_dim == 4   # max idx + 1 (parser.cpp:90)
    assert output_dim == 3  # max label + 1 (parser.cpp:91)


def test_svmlight_unlabeled_line_gets_minus_one():
    csr, vals, labels, _, _ = tparser.parse_svmlight_text(["x 0:3", "1 0:1", ""])
    assert list(labels) == [-1, 1, -1]
    assert list(csr.indptr) == [0, 0, 1, 1] and list(vals) == [1.0]  # no features either


def test_svmlight_empty_file_reports_dims_of_one():
    """The reference starts its maxima at 0 (parser.cpp:52-92)."""
    csr, vals, labels, input_dim, output_dim = tparser.parse_svmlight_text([])
    assert (input_dim, output_dim, csr.nnz, len(vals), len(labels)) == (1, 1, 0, 0, 0)


def test_split():
    assert list(tparser.parse_split_text(["1", "2", "3", "0", " "])) == [1, 2, 3, 0]


def _same(a, b):
    for f in dataclasses.fields(tds.GCNDataset):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("graph", "feature_index"):
            np.testing.assert_array_equal(x.indptr, y.indptr)
            np.testing.assert_array_equal(x.indices, y.indices)
            assert x.indptr.dtype == y.indptr.dtype and x.indices.dtype == y.indices.dtype
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        else:
            assert x == y


def test_roundtrip_through_files_and_both_parsers_agree(tmp_path, tiny_dataset):
    write_dataset(tiny_dataset, str(tmp_path), "tiny")
    ds = tparser.load_dataset("tiny", data_dir=str(tmp_path))
    assert isinstance(ds, tds.GCNDataset)
    np.testing.assert_array_equal(ds.graph.indptr, tiny_dataset.graph.indptr)
    np.testing.assert_array_equal(ds.graph.indices, tiny_dataset.graph.indices)
    np.testing.assert_array_equal(ds.label, tiny_dataset.label)
    np.testing.assert_array_equal(ds.split, tiny_dataset.split)
    np.testing.assert_array_equal(ds.feature_index.indices, tiny_dataset.feature_index.indices)
    np.testing.assert_allclose(ds.feature_value, tiny_dataset.feature_value, rtol=1e-5)
    assert (ds.num_nodes, ds.output_dim) == (tiny_dataset.num_nodes, tiny_dataset.output_dim)
    _same(ds, jparser.load_dataset("tiny", data_dir=str(tmp_path), use_native=False))
    np.testing.assert_allclose(ds.dense_features(), tiny_dataset.dense_features(), rtol=1e-5)


def test_both_parsers_agree_on_ragged_text(tmp_path):
    """Unparseable and empty lines, a last line without a newline."""
    (tmp_path / "r.graph").write_text("1 2\n\n0\n")
    (tmp_path / "r.svmlight").write_text("3 0:1 7:0.25\nnolabel 1:2\n\n0 2:1e-3")
    (tmp_path / "r.split").write_text("1\n2\n\n3\n0")
    ds = tparser.load_dataset("r", data_dir=str(tmp_path))
    _same(ds, jparser.load_dataset("r", data_dir=str(tmp_path), use_native=False))
    assert (ds.num_nodes, ds.input_dim, ds.output_dim) == (3, 8, 4)
    assert list(ds.label) == [3, -1, -1, 0] and list(ds.split) == [1, 2, 3, 0]


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="Cannot read input: .*nope.graph"):
        tparser.load_dataset("nope", data_dir=str(tmp_path))
    (tmp_path / "nope.graph").write_text("0\n")
    with pytest.raises(FileNotFoundError, match="nope.split"):
        tparser.load_dataset("nope", data_dir=str(tmp_path))


@pytest.mark.parametrize("feature_matmul", ["dense", "sparse"])
def test_cli_trains_from_text_files(tmp_path, tiny_dataset, capsys, feature_matmul):
    write_dataset(tiny_dataset, str(tmp_path), "tiny")
    assert cli.main(["tiny", "--data-dir", str(tmp_path), "--epochs", "2", "--device", "cpu",
                     "--feature-matmul", feature_matmul]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:4] == ["Parse Graph Succeeded.", "Parse Node Succeeded.",
                         "Parse Split Succeeded.", "RUNNING ON CPU"]
    assert lines[5].startswith("epoch=2 ") and lines[-1].startswith("test_loss=")


def test_cli_reports_a_missing_text_dataset(tmp_path, capsys):
    assert cli.main(["absent", "--data-dir", str(tmp_path), "--device", "cpu"]) == 1
    assert "Cannot read input: absent" in capsys.readouterr().err
