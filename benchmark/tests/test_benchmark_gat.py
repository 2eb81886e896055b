"""The GAT family (benchmark/families/gat.py) on the CPU: its cell enters a
copy of the benchmark as new files only and reads correct on a tiny graph,
untraced and traced; each step's masks read back (the attention's through the
family's own Philox, equal to the program's ``attention_keep``); the sound
reference passes the cell's limits while the TF32 control and every fault
fail them; the roofline's counts by hand."""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import compare, data, registry, synth
from benchmark.run import job_seed
from benchmark.tests.conftest import BENCH_DIR, TINY_GRAPH, run_tiny
from benchmark.tests.test_benchmark_families import TRAFFIC, bench_copy  # noqa: F401 (a fixture)


GAT_CELL_METRICS = ("epoch_ms", "epoch_mfu", "device_idle_share", "prepare_s", "capture_ms",
                    "attention_roofline", "attention_ms")


def _gat_config() -> dict:
    with open(os.path.join(BENCH_DIR, "configs", "gat2-reddit.json")) as f:
        config = json.load(f)
    config["name"] = "gat-tiny"
    config["graph"].update(TINY_GRAPH)
    return config


def _gat_limits() -> dict:
    with open(os.path.join(BENCH_DIR, "workloads", "reddit-gat-100ep.json")) as f:
        return json.load(f)["limits"]


def test_a_gat_cell_enters_as_new_files(bench_copy, capsys):
    """The GAT's configuration, traffic and cell as new files beside the
    benchmark's: a run on the CPU reads correct, untraced and traced, with
    the cell's own limits; the attention readers find no kernel there and
    leave their metrics out."""
    bench_copy.add_cell("gat-tiny-cell", _gat_config(), TRAFFIC, _gat_limits(),
                        metrics=GAT_CELL_METRICS)
    gat = registry.family("gat")
    rc, line, err = run_tiny(capsys, cell="gat-tiny-cell")
    assert rc == 0 and line["correct"] is True, (line, err[-2000:])
    assert set(line["metrics"]) == {"setup_s", "epoch_ms", "peak_mem_gib"}
    assert list(line["checks"]) == [*gat.NUMBERS, "failed_jobs"]
    rc, traced, err = run_tiny(capsys, trace=1, cell="gat-tiny-cell")
    assert rc == 0 and traced["correct"] is True, err[-2000:]
    assert {"epoch_mfu", "prepare_s", "device_idle_share"} <= set(traced["metrics"])
    assert not {"attention_ms", "attention_roofline"} & set(traced["metrics"])
    assert traced["metrics"]["epoch_mfu"]["value"] > 0
    bench_copy.assert_only_added()


@pytest.fixture(scope="module")
def gat_tiny():
    """The GAT family on the tiny graph: (family, config, graph, prep, the
    program's readings, the reference's inputs, the sound reference)."""
    gat = registry.family("gat")
    config = _gat_config()
    graph = synth.make_synthetic(data.spec_of(config["graph"]), seed=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prep = gat.prepare(config, TRAFFIC, graph, "cpu")
    seed = job_seed(2**31 + 21, "check")
    got = gat.check_steps(prep, graph, seed)
    inputs = gat.reference_inputs(graph, config, TRAFFIC, "cpu")
    ref = gat.follow(inputs, config, seed, got)
    yield gat, config, graph, prep, got, inputs, ref, seed
    torch.set_num_threads(threads)


def test_gat_masks_read_back(gat_tiny):
    """Each of the 3 steps gives X's mask, the hidden layer's [N, 64] and
    both layers' attention masks [E, K], kept near 1 - p, fresh each step;
    the family's Philox gives the program's ``attention_keep`` bit for bit."""
    from cuda_gcn_torch.ops.attention import attention_keep

    gat, config, graph, prep, got, *_ = gat_tiny
    n, e = int(graph["num_nodes"]), len(graph["indices"])
    assert len(got.masks) == gat.STEPS
    for step in got.masks:
        assert [tuple(m.shape) for m in step[1:]] == [(n, 64), (e, 8), (e, 1)]
        assert all(0.3 < float(m.float().mean()) < 0.5 for m in step[1:])
    assert not torch.equal(got.masks[0][2], got.masks[1][2])
    slots = torch.arange(5000, dtype=torch.int64)
    seeds = [2**62 + 12345, 2**40 + 7]
    assert torch.equal(gat.expand_mask(seeds, slots, 8, 0.6),
                       attention_keep(seeds, slots, 8, 0.6))


def test_gat_sound_passes_and_the_control_and_each_fault_fail(gat_tiny):
    gat, config, _, _, got, inputs, ref, seed = gat_tiny
    limits = _gat_limits()
    sound = gat.numbers(got, ref)
    assert compare.judge(sound, limits), sound
    bad = gat.numbers(gat.follow(inputs, config, seed, got, precision=gat.CONTROL), ref)
    assert not compare.judge(bad, limits), ("control", bad)
    for fault in gat.FAULTS:
        bad = gat.numbers(gat.follow(inputs, config, seed, got, fault=fault), ref)
        assert not compare.judge(bad, limits), (fault, bad)


def test_gat_roofline_by_hand():
    """An attention pass: 4 bytes a slot and a row pointer, z read and out
    written (N·K·F'), both scores; the epoch: each layer's two forwards and
    its backward, x twice for layer 0."""
    gat = registry.family("gat")
    s = gat.Shapes(nodes=10, nnz=30, feature_nnz=25, dims=(12, 8, 3), heads=(8, 1))
    fwd = gat.attention_pass(s, 0)
    assert fwd.bytes == 30 * 4 + 11 * 4 + 2 * 10 * 64 * 4 + 2 * 10 * 8 * 4
    assert fwd.flops == 30 * 8 * (2 * 8 + 4)
    bwd = gat.attention_backward(s, 1)
    assert bwd.bytes == 30 * 4 + 11 * 4 + 3 * 10 * 3 * 4 + 4 * 10 * 4
    per = gat.epoch(s, False)
    layers = gat.attention_pass(s, 0) + gat.attention_pass(s, 1)
    back = gat.attention_backward(s, 0) + gat.attention_backward(s, 1)
    assert per["attention"].bytes == 2 * layers.bytes + back.bytes
    assert per["layer0"].bytes == 2 * 10 * 12 * 4 and per["layer0"].flops == 3 * 2 * 10 * 12 * 64
    job = gat.job_work(s, 5, False)
    assert job["total"].bytes == job["attention"].bytes + job["layer0"].bytes
    assert job["attention"].bytes == 5 * per["attention"].bytes + 2 * layers.bytes
