"""The least time of a piece of work on one H100: the larger of its bytes
over ``HBM_BYTES_PER_S`` and its operations over the type's peak
(``PEAK_FLOPS``). A family counts a job's work from its shapes alone
(``job_work``), never from a layout of the program, so that the count reads
the same work whatever implements it.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth and the peak of
# each activation type (float32 outside the tensor cores, with TF32 off).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}
INDEX_BYTES = 4


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, k: float) -> "Work":
        return Work(self.bytes * k, self.flops * k)

    def least_s(self, dtype: str) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / PEAK_FLOPS[dtype])
