"""Feature-transform matmul (cuda_gcn_tpu/ops/matmul.py ``dense_matmul``).

A plain f32 product outside any TPU kernel, so it stays a library call;
device.resolve_device turns TF32 off so it runs in full f32.
"""

from __future__ import annotations

import torch


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[N, F] @ [F, H] in f32."""
    return torch.matmul(x, w)
