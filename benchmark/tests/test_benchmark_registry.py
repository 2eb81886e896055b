"""The benchmark's parts are found by name, and BENCHMARK.json keeps to the
contract's shape."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return registry.spec()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51


def test_every_config_cell_and_metric_is_a_file(bench):
    for c in bench["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert registry.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = registry.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["why"]) == (w["config"], w["traffic"],
                                                                  w["why"])
        family = registry.family(registry.family_name(registry.config(w["config"])))
        assert set(cell["limits"]) == set(family.NUMBERS)
        registry.traffic(w["traffic"])
        assert w["chips"] == 1
    for m in bench["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "epoch_ms", "peak_mem_gib"} <= e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_each_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in registry.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = registry.cell_metrics(bench, w["name"], "per_layer")
        assert per_layer
        # each per-layer metric moves an end-to-end metric that the cell reports
        assert all(m["moves"] in e2e for m in per_layer), w["name"]


def test_unknown_and_unsafe_names_are_refused():
    with pytest.raises(FileNotFoundError):
        registry.config("no-such-config")
    with pytest.raises(ValueError):
        registry.traffic("../BENCHMARK")


def test_file_is_small():
    path = os.path.join(registry.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) < 64 * 1024
    json.load(open(path))
