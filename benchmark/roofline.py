"""The least time of a training job's work on one H100, from its shapes alone.

The count reads the node count, the adjacency's nnz (self-loops included),
the feature matrix's nnz, the layer widths and the activations' type: never
a layout of the program (tiles, ELL buckets, bf16 planes), so that it reads
the same work whatever implements it. Each input is read once and each
output written once a pass:

* an adjacency pass at width d: its column indices (4 bytes an nnz) and row
  pointers (4 bytes a node), h read and out written (N·d each, in the
  activations' type); 2·nnz·d operations. The coefficients are not counted:
  they follow from the row lengths;
* layer 0 on dense x: x read once for the forward product (the training and
  the evaluation halves of a fused pass share the read) and once for dW, with
  2·N·F·H operations a product; on sparse x: its values and column indices
  (activation type + 4 bytes an nnz) and row pointers instead of x, 2·nnz·H
  operations a product; the products' outputs (N·H) are not counted;
* the least time of a piece of work is the larger of its bytes over
  ``HBM_BYTES_PER_S`` and its operations over the type's peak
  (``PEAK_FLOPS``).

A fixed-length epoch is the fused pair (the training forward and the
evaluation of the weights before the step in the same passes): forward at
widths 2H and 2C, backward at C and H, x read twice. An early-stopping
epoch evaluates after the step: forward H, C, backward C, H and the
evaluation's forward H, C, x read three times. A job adds its evaluations
(the fused loop's trailing one and the test one): forward H and C, x once.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates: HBM3 bandwidth and the peak of
# each activation type (float32 outside the tensor cores, with TF32 off).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEMSIZE = {"float32": 4, "bfloat16": 2}
INDEX_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Shapes:
    nodes: int
    nnz: int           # adjacency nnz, self-loops included
    feature_nnz: int   # nnz of the sparse feature matrix
    dims: tuple[int, int, int]  # (F, H, C)
    dtype: str = "float32"
    feature_matmul: str = "dense"


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


def adjacency_pass(s: Shapes, width: int) -> Work:
    item = ITEMSIZE[s.dtype]
    return Work(bytes=s.nnz * INDEX_BYTES + (s.nodes + 1) * INDEX_BYTES
                + 2 * s.nodes * width * item,
                flops=2.0 * s.nnz * width)


def layer0_read(s: Shapes) -> Work:
    """One read of x for a layer-0 product or dW, with that product's
    operations."""
    f, h, _ = s.dims
    item = ITEMSIZE[s.dtype]
    if s.feature_matmul == "sparse":
        return Work(bytes=s.feature_nnz * (item + INDEX_BYTES) + (s.nodes + 1) * INDEX_BYTES,
                    flops=2.0 * s.feature_nnz * h)
    return Work(bytes=s.nodes * f * item, flops=2.0 * s.nodes * f * h)


def _passes(s: Shapes, widths) -> Work:
    total = Work()
    for w in widths:
        total = total + adjacency_pass(s, w)
    return total


def epoch(s: Shapes, early_stopping: bool) -> dict[str, Work]:
    """{'aggregation', 'layer0'} of one epoch."""
    _, h, c = s.dims
    if early_stopping:
        # train forward (H, C), backward (C, H), evaluation forward (H, C);
        # x for the training product, dW and the evaluation product
        return {"aggregation": _passes(s, (h, c, c, h, h, c)),
                "layer0": layer0_read(s) * 3}
    # fused pair: forward at 2H and 2C, backward at C and H; x for the pair's
    # products (one read) and for dW; the pair's second product's operations
    pair = layer0_read(s)
    return {"aggregation": _passes(s, (2 * h, 2 * c, c, h)),
            "layer0": pair + Work(flops=pair.flops) + layer0_read(s)}


def evaluation(s: Shapes) -> dict[str, Work]:
    """{'aggregation', 'layer0'} of one evaluation forward."""
    _, h, c = s.dims
    return {"aggregation": _passes(s, (h, c)), "layer0": layer0_read(s)}


def job(s: Shapes, epochs: int, early_stopping: bool) -> dict[str, Work]:
    """{'aggregation', 'layer0', 'total'} of a job of ``epochs`` epochs: the
    epochs, the fixed-length loop's trailing evaluation and the test one."""
    per = epoch(s, early_stopping)
    ev = evaluation(s)
    n_evals = 1 if early_stopping else 2
    out = {k: per[k] * epochs + ev[k] * n_evals for k in per}
    out["total"] = out["aggregation"] + out["layer0"]
    return out
