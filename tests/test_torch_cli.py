"""The port's CLI against the JAX package's (cuda_gcn_tpu/cli.py).

The same argv gives the same ``GCNConfig`` (the nine positional overrides and
their ``--flag`` forms, the flag winning, the "inferred from the dataset"
note, the exit on a value that does not parse, ``--halo-dtype``); every flag
of the JAX CLI is accepted, its compile flags (``--platform``,
``--compilation-cache``, ``--prime-cache``) with the behaviour that
tests/test_torch_chunked.py checks. Checkpoints, history files and ``--timing`` run end to
end on synth-cora with ``--device cpu``; ``--mesh`` runs in
tests/test_torch_sharded.py.
"""

import csv
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from cuda_gcn_tpu import cli as jcli

from cuda_gcn_torch import cli as tcli
from cuda_gcn_torch.config import MODEL_FIELDS

# the port's flag of its GAT, which the JAX package has no model for
GAT_OPTIONS = {"--model"}

ARGVS = [
    ["synth-cora"],
    ["synth-cora", "2708", "1433", "32", "7", "0.3", "0.05", "1e-3", "12", "4"],
    ["synth-cora", "--hidden-dim", "8", "--dropout", "0.1", "--epochs", "3",
     "--learning-rate", "0.2", "--weight-decay", "0", "--early-stopping", "2"],
    ["synth-cora", "1", "2", "64", "--hidden-dim", "8", "--seed", "3", "--backend", "ell",
     "--feature-matmul", "sparse", "--compute-dtype", "bfloat16"],
    ["synth-pubmed", "5", "6", "16", "9", "--num-nodes", "4", "--output-dim", "2"],
    ["synth-cora", "--mesh", "2", "--halo-dtype", "float32", "--epochs", "3"],
]


def _options(parser) -> set[str]:
    return {s for a in parser._actions for s in a.option_strings}


def test_every_jax_flag_but_the_sharded_and_xla_ones():
    """No flag of the JAX CLI is left out any more: ``--mesh`` and
    ``--halo-dtype`` came with the sharded trainer, XLA's compile flags with
    the chunked runners; the port adds ``--device``, ``--build-kernels`` and
    its GAT's flags."""
    compile_flags = {"--platform", "--compilation-cache", "--prime-cache"}
    jax_opts = _options(jcli.build_argparser())
    port_opts = _options(tcli.build_argparser())
    assert compile_flags <= jax_opts
    assert jax_opts <= port_opts
    assert {"--mesh", "--halo-dtype"} <= port_opts
    assert port_opts - jax_opts == {"--device", "--build-kernels", *GAT_OPTIONS}


@pytest.mark.parametrize("argv", ARGVS)
def test_config_from_args_matches_jax(argv, capsys):
    want = dataclasses.asdict(jcli.config_from_args(jcli.build_argparser().parse_args(argv)))
    want_err = capsys.readouterr().err
    got = dataclasses.asdict(tcli.config_from_args(tcli.build_argparser().parse_args(argv)))
    assert {k: v for k, v in got.items() if k not in MODEL_FIELDS} == want
    assert got["model"] == "gcn"
    assert capsys.readouterr().err == want_err
    if any(a in argv for a in ("1", "5", "--num-nodes")):
        assert "inferred from the dataset; override ignored" in want_err


@pytest.mark.parametrize("argv", [["synth-cora", "1", "2", "abc"],
                                  ["synth-cora", "1", "2", "3", "4", "half"]])
def test_an_invalid_override_exits_with_its_message(argv):
    messages = []
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            cli.config_from_args(cli.build_argparser().parse_args(argv))
        messages.append(str(e.value))
    assert messages[0] == messages[1] and messages[0].startswith("invalid value for ")


def test_too_many_overrides(capsys):
    assert tcli.main(["synth-cora", *["1"] * 10, "--device", "cpu"]) == 1
    assert "too many positional overrides" in capsys.readouterr().err


def _epoch_rows(out: str) -> list[str]:
    return [line for line in out.splitlines() if line.startswith("epoch=")]


def test_checkpoint_metrics_and_timing_end_to_end(tmp_path, capsys):
    """4 epochs against 2, saved, then 2 resumed from the file, at dropout 0:
    the resumed run's metrics are epochs 3-4; the history files parse and the
    timing report names all 13 phases."""
    ck, mcsv, mjsonl = (str(tmp_path / n) for n in ("c.npz", "m.csv", "m.jsonl"))
    base = ["synth-cora", "--device", "cpu", "--dropout", "0"]
    assert tcli.main([*base, "--epochs", "4", "--metrics-jsonl", mjsonl]) == 0
    full = [json.loads(line) for line in open(mjsonl)]
    capsys.readouterr()
    assert tcli.main([*base, "--epochs", "2", "--save-checkpoint", ck]) == 0
    assert f"checkpoint saved to {ck}" in capsys.readouterr().out
    assert tcli.main([*base, "--epochs", "2", "--load-checkpoint", ck, "--metrics-csv", mcsv,
                      "--metrics-jsonl", mjsonl, "--timing"]) == 0
    out = capsys.readouterr().out
    assert f"restored checkpoint from {ck}" in out and len(_epoch_rows(out)) == 2
    resumed = [json.loads(line) for line in open(mjsonl)]
    assert set(resumed[0]["meta"]) == {"dataset", "seed", "backend", "platform", "test_loss",
                                       "test_acc", "total_train_time"}
    assert resumed[0]["meta"]["platform"] == "CPU"
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    assert [[r[k] for k in keys] for r in resumed[1:]] == [[r[k] for k in keys]
                                                             for r in full[3:]]
    rows = list(csv.DictReader(open(mcsv)))
    assert [r["epoch"] for r in rows] == ["1", "2"]
    np.testing.assert_array_equal([float(r["val_loss"]) for r in rows],
                                  [r["val_loss"] for r in resumed[1:]])
    report = re.findall(r"^(\w+) average time: (\d+\.\d{3})ms$", out, re.M)
    assert sorted(name for name, _ in report) == sorted([
        "train", "test", "matmul_fw", "matmul_bw", "spmatmul_fw", "spmatmul_bw",
        "graphsum_fw", "graphsum_bw", "loss_fw", "relu_fw", "relu_bw", "dropout_fw",
        "dropout_bw"])
    assert all(float(ms) >= 0 for _, ms in report)


def test_build_kernels_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli.main(["synth-cora", "--build-kernels"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        tcli.main(["synth-cora", "--build-kernels", "--device", "cpu"])


def test_model_gat_takes_the_papers_settings_where_none_are_given():
    """``--model gat``: 8 features a head, dropout 0.6, learning rate 0.005
    unless the command gives them (positionally or as flags); 8 heads and one
    output head, attention dropout 0.6, slope 0.2."""
    cfg = tcli.config_from_args(tcli.build_argparser().parse_args(["synth-cora", "--model", "gat"]))
    assert (cfg.model, cfg.hidden_dim, cfg.dropout, cfg.learning_rate) == ("gat", 8, 0.6, 0.005)
    assert cfg.layer_heads() == (8, 1) and cfg.attention_dropout == 0.6 and cfg.leaky_slope == 0.2
    cfg = tcli.config_from_args(tcli.build_argparser().parse_args(
        ["synth-cora", "0", "0", "4", "0", "0.3", "--model", "gat", "--learning-rate", "0.01"]))
    assert (cfg.hidden_dim, cfg.dropout, cfg.learning_rate) == (4, 0.3, 0.01)


def test_model_gat_trains_through_the_cli(capsys):
    """``--model gat`` trains on the ell backend ('auto' picks it) and prints
    the reference's lines; ``--mesh`` and ``--timing`` exit 1 for it."""
    assert tcli.main(["synth-cora", "--model", "gat", "--epochs", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"^epoch=2 train_loss=\d+\.\d{5} ", out, re.M)
    assert re.search(r"^test_loss=\d+\.\d{5} test_acc=", out, re.M)
    for extra in (["--mesh", "2"], ["--timing"]):
        assert tcli.main(["synth-cora", "--model", "gat", "--device", "cpu", *extra]) == 1
    assert "--model gat" in capsys.readouterr().err
