"""Finding the benchmark's parts by name: ``BENCHMARK.json`` at the root of the
checkout, and under ``benchmark/`` a file each configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell
(``workloads/<name>.json``), per-layer metric (``metrics/<name>.py``, a
``read(ctx)`` that returns the metric or None) and model family
(``families/<name>.py``, families/__init__.py)."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

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


def _module(kind: str, name: str):
    path = _path(kind, name, ".py")
    spec_ = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec_)
    sys.modules[spec_.name] = module  # a dataclass looks its module up while it is made
    spec_.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _module("metrics", name).read


FAMILY_API = ("NUMBERS", "FAULTS", "CONTROL", "prepare", "run_job", "check_steps",
              "reference_inputs", "follow", "numbers", "shapes", "job_work")


def family_name(config: dict) -> str:
    """The model family a configuration names (``model.family``), 'gcn' where none."""
    return config["model"].get("family", "gcn")


def family(name: str):
    """The module ``families/<name>.py``, which gives every name of ``FAMILY_API``."""
    module = _module("families", name)
    missing = [a for a in FAMILY_API if not hasattr(module, a)]
    if missing:
        raise ValueError(f"family {name!r} lacks {', '.join(missing)}")
    return module


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The entries of ``bench[kind]`` ('end_to_end' or 'per_layer') that the
    cell reports: those without a ``workloads`` list, and those that name it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
