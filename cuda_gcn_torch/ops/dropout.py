"""Inverted dropout with an explicit generator (cuda_gcn_tpu/ops/dropout.py).

Keep an element with probability 1-p and scale kept values by 1/(1-p); identity
when not training (src/seq/module.cpp:207-221); the result keeps x's type. The
JAX package draws threefry
bits, which torch cannot reproduce, so parity with it is distributional.
"""

from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            training: bool) -> torch.Tensor:
    if not training or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
