"""The control of the comparison reads not correct against each cell's
limits: the reference in the program's place with TF32 products (the
precision a float32 product runs in on this card with TF32 on), on three
seeds. On the CPU at pubmed's own size (the reference alone); on the card
at every cell's size, with the program's sound readings beside it."""

from __future__ import annotations

import pytest
import torch

from benchmark import compare, data, registry
from benchmark.run import job_seed

SEEDS = (2**31 + 1, 2**31 + 2, 2**31 + 3)
CELLS = ["reddit-dense-100ep", "pubmed-200ep", "reddit-sparse-100ep"]


def _cell(name):
    cell = registry.workload(name)
    return cell, registry.config(cell["config"]), registry.traffic(cell["traffic"])


@pytest.mark.parametrize("name", ["pubmed-200ep"])
def test_control_fails_on_the_cpu(name):
    cell, config, traffic = _cell(name)
    family = registry.family(registry.family_name(config))
    graph = data.synth.make_synthetic(data.spec_of(config["graph"]), config["graph"]["seed"])
    model = config["model"]
    inputs = family.reference_inputs(graph, config, traffic, "cpu")
    n = int(graph["num_nodes"])
    for seed in SEEDS:
        gen = torch.Generator().manual_seed(seed)  # masks as the program might draw them
        masks = [(torch.rand(len(graph["f_values"]), generator=gen) >= model["dropout"],
                  *(torch.rand(n, h, generator=gen) >= model["dropout"]
                    for h in family.hidden_dims(model)))
                 for _ in range(family.STEPS)]
        drawn = family.Readings([], [], 0.0, [], [], masks=masks)
        ref = family.follow(inputs, config, job_seed(seed, "check"), drawn)
        control = family.numbers(family.follow(inputs, config, job_seed(seed, "check"), drawn,
                                               precision=family.CONTROL), ref)
        assert not compare.judge(control, cell["limits"]), control


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    from benchmark import readings

    cell, config, _ = _cell(name)
    family = registry.family(registry.family_name(config))
    out = readings.collect(name, list(SEEDS), list(SEEDS))
    for s in SEEDS:
        assert compare.judge(out["sound"][s], cell["limits"]), out["sound"][s]
        assert not compare.judge(out["control"][s], cell["limits"]), out["control"][s]
        for fault in family.FAULTS:
            assert not compare.judge(out["faults"][fault][s], cell["limits"])
