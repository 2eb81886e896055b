"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do). With no card and no explicit CPU request
they raise; they never carry on on the CPU.

Resolving a device also turns TF32 off for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), and reduced-precision reductions off for
bf16 products (``allow_bf16_reduced_precision_reduction``): f32 parity with
the JAX package, which multiplies in full f32 and sums bf16 products in f32,
depends on it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cuda_gcn_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` warm calls, by CUDA events
    (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
