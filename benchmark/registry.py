"""Finding the benchmark's parts by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``benchmark/`` a file each configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell
(``workloads/<name>.json``) and per-layer metric (``metrics/<name>.py``, a
``read(ctx)`` that returns the metric or None)."""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, ext: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(BENCH_DIR, kind, f"{name}{ext}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r} ({path})")
    return path


def _json(kind: str, name: str) -> dict:
    with open(_path(kind, name, ".json")) as f:
        return json.load(f)


def spec(root: str | None = None) -> dict:
    with open(os.path.join(root or ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec_ = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                   _path("metrics", name, ".py"))
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The entries of ``bench[kind]`` ('end_to_end' or 'per_layer') that the
    cell reports: those without a ``workloads`` list, and those that name it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
