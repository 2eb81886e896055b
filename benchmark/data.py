"""A configuration's graph: generated once at its own seed by the frozen
generator (synth.py) and cached in ``benchmark/.cache/data/``, a fixed
directory inside the checkout, so that only a cell's first run there pays for
the generation."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from benchmark import synth

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache", "data")
_SIZES = ("num_nodes", "num_edges", "num_classes", "input_dim")


def spec_of(graph: dict) -> synth.SynthSpec:
    return synth.spec_for(*(graph[k] for k in _SIZES), **graph.get("spec", {}))


def cache_path(config: dict) -> str:
    graph = config["graph"]
    key = hashlib.sha256(json.dumps(graph, sort_keys=True).encode()).hexdigest()[:12]
    return os.path.join(CACHE_DIR, f"{config['name']}.{key}.npz")


def load_graph(config: dict) -> tuple[dict, bool]:
    """(the arrays of ``config``'s graph, whether they were generated now)."""
    path = cache_path(config)
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: (int(z[k]) if z[k].ndim == 0 else z[k]) for k in z.files}, False
    data = synth.make_synthetic(spec_of(config["graph"]), seed=config["graph"]["seed"])
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **data)
    os.replace(tmp, path)
    return data, True
