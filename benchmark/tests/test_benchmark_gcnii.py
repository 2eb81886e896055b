"""The GCNII family (benchmark/families/gcnii.py) on the CPU: its cell enters
a copy of the benchmark as new files only and reads correct on a tiny graph,
untraced and traced; each step's masks read back; the sound reference passes
the cell's limits while the TF32 control and every fault fail them; the
roofline's counts by hand."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import compare, data, registry, synth
from benchmark.run import job_seed
from benchmark.tests.conftest import BENCH_DIR, TINY_GRAPH, run_tiny
from benchmark.tests.test_benchmark_families import TRAFFIC, bench_copy  # noqa: F401 (a fixture)

GCNII_CELL_METRICS = ("epoch_ms", "epoch_mfu", "device_idle_share", "prepare_s", "capture_ms",
                      "propagation_ms", "propagation_roofline")
LAYERS = 8  # of the tiny cell: the configuration's 64 cut, for the CPU's time


def _gcnii_config(layers=LAYERS) -> dict:
    with open(os.path.join(BENCH_DIR, "configs", "gcnii64-reddit.json")) as f:
        config = json.load(f)
    config["name"] = "gcnii-tiny"
    config["model"]["layers"] = layers
    config["graph"].update(TINY_GRAPH)
    return config


def _gcnii_limits() -> dict:
    with open(os.path.join(BENCH_DIR, "workloads", "reddit-gcnii64-100ep.json")) as f:
        return json.load(f)["limits"]


def test_a_gcnii_cell_enters_as_new_files(bench_copy, capsys):
    """GCNII's configuration, traffic and cell as new files beside the
    benchmark's: a run on the CPU reads correct, untraced and traced, with
    the cell's own limits; the propagation readers find no kernel there and
    leave their metrics out."""
    bench_copy.add_cell("gcnii-tiny-cell", _gcnii_config(), TRAFFIC, _gcnii_limits(),
                        metrics=GCNII_CELL_METRICS)
    gcnii = registry.family("gcnii")
    rc, line, err = run_tiny(capsys, cell="gcnii-tiny-cell")
    assert rc == 0 and line["correct"] is True, (line, err[-2000:])
    assert set(line["metrics"]) == {"setup_s", "epoch_ms", "peak_mem_gib"}
    assert list(line["checks"]) == [*gcnii.NUMBERS, "failed_jobs"]
    rc, traced, err = run_tiny(capsys, trace=1, cell="gcnii-tiny-cell")
    assert rc == 0 and traced["correct"] is True, err[-2000:]
    assert {"epoch_mfu", "prepare_s", "device_idle_share"} <= set(traced["metrics"])
    assert not {"propagation_ms", "propagation_roofline"} & set(traced["metrics"])
    assert traced["metrics"]["epoch_mfu"]["value"] > 0
    bench_copy.assert_only_added()


@pytest.fixture(scope="module")
def gcnii_tiny():
    """The GCNII family on the tiny graph: (family, config, graph, the
    program's readings, the reference's inputs, the sound reference, seed)."""
    gcnii = registry.family("gcnii")
    config = _gcnii_config()
    graph = synth.make_synthetic(data.spec_of(config["graph"]), seed=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prep = gcnii.prepare(config, TRAFFIC, graph, "cpu")
    seed = job_seed(2**31 + 24, "check")
    got = gcnii.check_steps(prep, graph, seed)
    inputs = gcnii.reference_inputs(graph, config, TRAFFIC, "cpu")
    ref = gcnii.follow(inputs, config, seed, got)
    yield gcnii, config, graph, got, inputs, ref, seed
    torch.set_num_threads(threads)


def test_gcnii_masks_read_back(gcnii_tiny):
    """Each of the 3 steps gives X's mask and one [N, 64] mask a convolution
    and the output layer, kept near 1 - p, fresh each step."""
    gcnii, config, graph, got, *_ = gcnii_tiny
    n = int(graph["num_nodes"])
    assert len(got.masks) == gcnii.STEPS
    for step in got.masks:
        assert [tuple(m.shape) for m in step[1:]] == [(n, 64)] * (LAYERS + 1)
        assert all(0.35 < float(m.float().mean()) < 0.45 for m in step[1:])
    assert not torch.equal(got.masks[0][1], got.masks[1][1])
    assert not torch.equal(got.masks[0][1], got.masks[0][2])


def test_gcnii_sound_passes_and_the_control_and_each_fault_fail(gcnii_tiny):
    """The cell's limits: the sound reference within them, the control and
    every fault outside. 'dropout_rate' is read by ``mask_z`` alone, whose
    limit is set at reddit's 15M entries a mask: on 38,400 its reading is
    held to lie far above the sound one instead."""
    gcnii, config, _, got, inputs, ref, seed = gcnii_tiny
    limits = _gcnii_limits()
    sound = gcnii.numbers(got, ref)
    assert compare.judge(sound, limits), sound
    bad = gcnii.numbers(gcnii.follow(inputs, config, seed, got, precision=gcnii.CONTROL), ref)
    assert not compare.judge(bad, limits), ("control", bad)
    for fault in gcnii.FAULTS:
        bad = gcnii.numbers(gcnii.follow(inputs, config, seed, got, fault=fault), ref)
        if fault == "dropout_rate":
            assert bad["mask_z"] > 5 * max(sound["mask_z"], 1.0), (fault, bad)
            continue
        assert not compare.judge(bad, limits), (fault, bad)


def test_gcnii_roofline_by_hand():
    """A blended pass: 8 bytes a slot, h, h0 read and s written (N·d each);
    the transposed pass: g read and its gradient written; the epoch: each
    layer's pair pass at 2·H and its transposed pass at H."""
    gcnii = registry.family("gcnii")
    s = gcnii.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(12, 8, 3), layers=4)
    fwd = gcnii.blended_pass(s, 16)
    assert fwd.bytes == 30 * 8 + 3 * 10 * 16 * 4 and fwd.flops == 2 * 30 * 16 + 3 * 10 * 16
    bwd = gcnii.transposed_pass(s, 8)
    assert bwd.bytes == 30 * 8 + 2 * 10 * 8 * 4 and bwd.flops == 2 * 30 * 8
    per = gcnii.epoch(s, False)
    assert per["propagation"].bytes == 4 * (fwd.bytes + bwd.bytes)
    assert per["products"].flops == 4 * (4 * 2 * 10 * 8 * 8 + 2 * 10 * 8 * 3)
    assert per["layer0"].bytes == 2 * 10 * 12 * 4 and per["layer0"].flops == 3 * 2 * 10 * 12 * 8
    job = gcnii.job_work(s, 5, False)
    ev = gcnii.evaluation(s)
    assert job["propagation"].bytes == 5 * per["propagation"].bytes + 2 * ev["propagation"].bytes
    assert job["total"].bytes == sum(job[k].bytes for k in ("propagation", "products", "layer0"))
