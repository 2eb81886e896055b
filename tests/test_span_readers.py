"""The benchmark's readers of the program's spans (benchmark/metrics/
capture_ms.py, capture_ms.sweep.py, loop_idle_ms.sweep.py) on hand-built
slices of a trace: exact values for two jobs with known spans and device
intervals, and None where the slice holds no program span, as a trace of a
program without spans does."""

import pytest

from benchmark.registry import metric_reader
from benchmark.run import Context
from benchmark.trace import Slice

# two jobs in a slice of [0, 1000] µs: the loop, its eager epoch and capture,
# and host events the readers pass over
HOST = [("train.create_state", 20, 90, 1), ("train.epochs", 100, 400, 1),
        ("graphs.eager", 110, 150, 1), ("graphs.capture", 160, 200, 1),
        ("train.chunk_read", 350, 380, 1), ("cudaGraphLaunch", 250, 260, 1),
        ("train.epochs", 500, 800, 1), ("graphs.eager", 510, 540, 1),
        ("graphs.capture", 560, 620, 1), ("cudaMalloc", 565, 570, 1)]
# device operations: across the first loop's start, inside the eager epoch,
# across the first capture's end, inside, across the first loop's end, and a
# copy that overlaps a kernel
DEVICE = [("k", 90, 105), ("k", 120, 130), ("k", 190, 230), ("k", 300, 340), ("k", 395, 420),
          ("k", 700, 760), ("memcpy", 750, 790)]
# the loops outside eager and capture: [100, 110] + [150, 160] + [200, 400] (220 µs)
# and [500, 510] + [540, 560] + [620, 800] (210 µs); busy there 5 + 30 + 40 + 5 and 90 µs
LOOP_IDLE_MS = 1e-3 * ((220 - 80) + (210 - 90)) / 2
CAPTURE_MS = 1e-3 * (40 + 60) / 2


def _ctx(host=HOST, device=DEVICE, records_ok=True, jobs=(200, 200)):
    kernels = [d for d in device if d[0] == "k"]
    sl = Slice(start=0.0, end=1000.0, device=list(device), host=list(host), kernels=kernels)
    return Context(sl, records_ok, list(jobs), None, False, 0.0)


@pytest.mark.parametrize("name", ["capture_ms", "capture_ms.sweep"])
def test_capture_ms(name):
    assert metric_reader(name)(_ctx()) == pytest.approx(CAPTURE_MS, rel=1e-12)


# a copy inside a kernel's interval and a kernel inside an eager epoch change nothing
@pytest.mark.parametrize("device", [DEVICE, DEVICE + [("memcpy", 710, 750), ("k", 112, 148)]])
def test_loop_idle_ms(device):
    got = metric_reader("loop_idle_ms.sweep")(_ctx(device=device))
    assert got == pytest.approx(LOOP_IDLE_MS, rel=1e-12)


NO_SPANS = [h for h in HOST if not h[0].startswith(("train.", "graphs."))]


@pytest.mark.parametrize("name", ["capture_ms", "capture_ms.sweep", "loop_idle_ms.sweep"])
def test_no_program_span_reads_none(name):
    assert metric_reader(name)(_ctx(host=NO_SPANS)) is None


@pytest.mark.parametrize("case", ["no device operation", "records lost"])
def test_loop_idle_needs_the_device_records(case):
    ctx = _ctx(device=[]) if case == "no device operation" else _ctx(records_ok=False)
    assert metric_reader("loop_idle_ms.sweep")(ctx) is None
