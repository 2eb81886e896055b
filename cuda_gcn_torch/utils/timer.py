"""Named phase timers (cuda_gcn_tpu/utils/timer.py): the reference's 13-slot
accumulator (src/common/timer.h:5-26) as a small registry with its
start/stop/total API.

``stop(name, sync=t)`` synchronises the CUDA device of tensor ``t`` before it
reads the clock, so a phase that ends in device work is timed to its end; for
a CPU tensor there is nothing to wait for.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

# Phase names of the reference enum (timer.h:5-20).
TMR_TRAIN = "train"
TMR_TEST = "test"
TMR_MATMUL_FW = "matmul_fw"
TMR_MATMUL_BW = "matmul_bw"
TMR_SPMATMUL_FW = "spmatmul_fw"
TMR_SPMATMUL_BW = "spmatmul_bw"
TMR_GRAPHSUM_FW = "graphsum_fw"
TMR_GRAPHSUM_BW = "graphsum_bw"
TMR_LOSS_FW = "loss_fw"
TMR_RELU_FW = "relu_fw"
TMR_RELU_BW = "relu_bw"
TMR_DROPOUT_FW = "dropout_fw"
TMR_DROPOUT_BW = "dropout_bw"


class PhaseTimer:
    def __init__(self):
        self._start: dict[str, float] = {}
        self._total: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str, sync: torch.Tensor | None = None) -> float:
        """Stop ``name``; if ``sync`` is a CUDA tensor, wait for its device first."""
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        elapsed = time.perf_counter() - self._start[name]
        self._total[name] += elapsed
        self._count[name] += 1
        return elapsed

    def reset(self, *names: str) -> None:
        """Zero the given accumulators (all when none is named). train.run
        resets its phases on entry, so that its totals are per run."""
        for name in names or list(self._total):
            self._total.pop(name, None)
            self._count.pop(name, None)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        """Record time measured elsewhere (utils/profiling.py)."""
        self._total[name] += seconds
        self._count[name] += count

    def total(self, name: str) -> float:
        return self._total[name]

    def average_ms(self, name: str) -> float:
        c = self._count[name]
        return (self._total[name] / c) * 1000.0 if c else 0.0

    def report(self) -> str:
        """PRINT_TIMER_AVERAGE-style summary (timer.h:26)."""
        return "\n".join(f"{name} average time: {self.average_ms(name):.3f}ms"
                         for name in self._total)


# Process-wide instance, like the reference's translation-unit statics.
timers = PhaseTimer()
