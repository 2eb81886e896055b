"""Profiling (cuda_gcn_tpu/utils/profiling.py): a torch.profiler trace, a
speed-of-light model of one aggregation pass, and per-op device times.

* ``trace(logdir)`` — a context manager around ``torch.profiler`` that writes
  ``<logdir>/trace.json``, a Chrome trace of the host and, on the card, of
  every kernel;
* ``spmm_speed_of_light`` — the least time of one pass on the card: a random
  row gather moves at least ``max(row_bytes, GATHER_TRANSACTION_BYTES)`` per
  edge from HBM, dense tiles stream at ``hbm_gbps``; and the share of that
  bound a measured pass reaches;
* ``populate_op_timers`` — the device time of every per-op phase of the
  reference's timers at the run's real shapes, into utils/timer.py's
  ``timers``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# The least a random row gather moves from HBM: one 32-byte L2 sector (the
# H100's L2 line is four such sectors, each filled on its own; NVIDIA's CUDA C++
# Best Practices Guide, "Coalesced Access to Global Memory").
GATHER_TRANSACTION_BYTES = 32
# HBM3 peak of the H100 SXM at its 700 W limit (NVIDIA's data sheet): the rate
# of every bytes bound in PERF.md.
DEFAULT_HBM_GBPS = 3350.0


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def spmm_speed_of_light(nnz: int, dim: int, measured_s: float,
                        dense_tile_bytes: int = 0, residual_nnz: int | None = None,
                        itemsize: int = 4, hbm_gbps: float = DEFAULT_HBM_GBPS) -> dict:
    """Roofline share of one aggregation pass.

    nnz: total edges; residual_nnz: edges on the gather path (all by default);
    dense_tile_bytes: bytes of dense tiles streamed per pass.
    """
    residual = nnz if residual_nnz is None else residual_nnz
    gather_bytes = residual * max(dim * itemsize, GATHER_TRANSACTION_BYTES)
    ideal_s = (gather_bytes + dense_tile_bytes) / (hbm_gbps * 1e9)
    return {
        "ideal_s": ideal_s,
        "measured_s": measured_s,
        "sol_fraction": ideal_s / measured_s if measured_s > 0 else 0.0,
        "gather_bytes": gather_bytes,
        "dense_tile_bytes": dense_tile_bytes,
    }


def _seconds_per_call(fn, device: torch.device, repeats: int) -> float:
    """Mean seconds per call of ``fn`` over ``repeats`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / repeats


@torch.no_grad()
def populate_op_timers(graph, x, params: dict[str, torch.Tensor], truth: torch.Tensor,
                       seed: int, *, dropout_rate: float = 0.5,
                       repeats: int | None = None) -> dict:
    """Time every per-op phase of the reference (src/common/timer.h:5-26,
    src/seq/module.cpp) at the run's shapes and record it in ``timers``.

    Each op runs ``repeats`` times (50 below 50,000 nodes, 10 above) after a
    warm-up, on the tensors of a forward at ``params``: on the card the
    graphsum phases launch kernels 1 and 2 (``bsr``), 2 (``segment``) or 3
    (``ell``, ``pallas``), and with sparse features the layer-0 phases
    launch kernels 2 (X·W) and 3 (dW). The dropout draws come from their own
    generator, seeded with ``seed``, so the run's stream is not touched.
    Returns {phase: mean seconds}."""
    from cuda_gcn_torch.models.gcn import _layer0_transform
    from cuda_gcn_torch.ops import graphsum as gs
    from cuda_gcn_torch.ops.dropout import dropout
    from cuda_gcn_torch.ops.loss import masked_cross_entropy
    from cuda_gcn_torch.ops.matmul import SparseFeatures, csr_matmul_dw, dense_matmul
    from cuda_gcn_torch.utils import timer as T

    n = graph.n_nodes
    if repeats is None:
        repeats = 50 if n < 50_000 else 10
    w1, w2 = params["w1"].detach(), params["w2"].detach()
    sparse_x = isinstance(x, SparseFeatures)
    # what the reference's layer-0 Dropout touches: dense x, or the nnz values
    # of the sparse one (gcn.cpp:23)
    drop_target = x.values if sparse_x else x
    device = drop_target.device
    z1 = _layer0_transform(x, w1, 0.0, None, False)
    h1 = torch.relu(gs.forward(z1, graph))
    z2 = dense_matmul(h1, w2)
    logits = gs.forward(z2, graph)
    g2 = torch.ones_like(logits) / n
    g1 = torch.ones_like(z1) / n
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # dropout's backward multiplies by the mask its forward drew
    keep = torch.rand(drop_target.shape, generator=gen, device=device) < 1.0 - dropout_rate
    bw_mask = keep.to(drop_target.dtype) / (1.0 - dropout_rate)

    def layer0_dw():
        if sparse_x:
            return csr_matmul_dw(x, x.values.to(w1.dtype), g1)
        return torch.matmul(x.t(), g1).to(w1.dtype)

    def loss_and_grad():
        # the reference's CrossEntropyLoss computes its gradient in the
        # forward (module.cpp:145-158): the phase times both
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            return torch.autograd.grad(masked_cross_entropy(lg, truth), lg)[0]

    ops = {
        T.TMR_DROPOUT_FW: lambda: dropout(drop_target, dropout_rate, gen, True),
        T.TMR_DROPOUT_BW: lambda: drop_target * bw_mask,
        T.TMR_SPMATMUL_FW: lambda: _layer0_transform(x, w1, 0.0, None, False),
        T.TMR_SPMATMUL_BW: layer0_dw,
        T.TMR_GRAPHSUM_FW: lambda: gs.forward(z1, graph),
        T.TMR_GRAPHSUM_BW: lambda: gs.transpose_forward(g2, graph),
        T.TMR_RELU_FW: lambda: torch.relu(z1),
        T.TMR_RELU_BW: lambda: torch.where(h1 > 0, g1, 0.0),
        T.TMR_MATMUL_FW: lambda: dense_matmul(h1, w2),
        T.TMR_MATMUL_BW: lambda: (dense_matmul(g2, w2.t()), torch.matmul(h1.t(), g2)),
        T.TMR_LOSS_FW: loss_and_grad,
    }
    out = {}
    for name, fn in ops.items():
        avg = _seconds_per_call(fn, device, repeats)
        T.timers.add(name, avg * repeats, repeats)
        out[name] = avg
    return out
