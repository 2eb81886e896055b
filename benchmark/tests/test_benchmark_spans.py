"""The program's spans in a profiler trace on the card: two short jobs of the
tiny cell (conftest.py ``tiny_bench``) through the window's own calls
(program.run_job), under torch.profiler with the card's activity, read back
by trace.read as a traced run reads its slice.

    python3 -m pytest benchmark/tests -q -m card
"""

from __future__ import annotations

import os

import pytest

from benchmark import trace

JOBS = 2
SLICE = "test.slice"
# spans that open once a job, outside every other program span
ONCE_A_JOB = ("train.create_state", "train.epochs")
# spans that open once a job inside the job's train.epochs
IN_THE_LOOP = ("graphs.eager", "graphs.capture", "train.chunk_read", "train.trailing_eval")


def traced_jobs(path: str) -> tuple[trace.Slice, dict]:
    """``JOBS`` jobs of the tiny cell on the card, after one warm job, traced
    into the Chrome trace at ``path``: (the slice, the program's launches in it)."""
    import torch
    from cuda_gcn_torch import kernels

    from benchmark import data, program, registry

    config = registry.config("tiny")
    graph, _ = data.load_graph(config)
    prep = program.prepare(config, registry.traffic("t"), graph, "cuda")
    program.run_job(prep, 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = dict(kernels.launches)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            for seed in range(JOBS):
                program.run_job(prep, 2 + seed)
            torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in kernels.launches.items()}
    prof.export_chrome_trace(path)
    return trace.read(path, SLICE), launched


def spans_of(sl: trace.Slice, name: str) -> list[tuple[float, float]]:
    return sorted((s, e) for n, s, e, _ in sl.host if n == name)


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.card
def test_spans_in_a_card_trace(card, tiny_bench, tmp_path):
    tiny_bench()
    sl, launched = traced_jobs(os.path.join(tmp_path, "trace.json"))
    assert trace.launches_match(sl, launched) == []
    loops = spans_of(sl, "train.epochs")
    for name in ONCE_A_JOB + IN_THE_LOOP:
        assert len(spans_of(sl, name)) == JOBS, name
    for name in IN_THE_LOOP:
        for span, loop in zip(spans_of(sl, name), loops):
            assert inside(span, loop), name
    # the test evaluation a job ends with, after its loop; the trailing
    # evaluation's own train.eval lies inside the loop
    tests = [s for s in spans_of(sl, "train.eval") if not any(inside(s, lp) for lp in loops)]
    assert len(tests) == JOBS and all(t[0] >= lp[1] for t, lp in zip(tests, loops))
    # the capture runs nothing of the epoch: the only kernels that start inside
    # it are the fills with which torch's capture prologue sets the seed and
    # offset of each registered Philox generator (the run's and the default)
    for s, e in spans_of(sl, "graphs.capture"):
        ran = [trace.short_name(k[0]) for k in sl.kernels if s <= k[1] <= e]
        assert len(ran) <= 4 and all("FillFunctor" in n for n in ran), ran
    assert not spans_of(sl, "train.stop_flag")
