"""Adam with the reference's update rule (cuda_gcn_tpu/ops/adam.py:58-79,
src/seq/optim.cpp:24-37):

    step_size = lr * sqrt(1 - beta2^t) / (1 - beta1^t)
    m = beta1*m + (1-beta1)*g
    v = beta2*v + (1-beta2)*g²
    w -= step_size * m / (sqrt(v) + eps)

``torch.optim.Adam`` puts eps inside the bias correction, so it is not used.
Weight decay enters only through the L2 term of the loss (ops/loss.py). The
parameters and moments are updated in place, and the step counter stays on the
device, so a step never waits for the host. The moments are f32 whatever the
parameters' type, and a step is taken in f32 and rounded once to the
parameter's type (cuda_gcn_tpu/ops/adam.py:61-69).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamParams:
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class AdamState:
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    step: torch.Tensor  # scalar int32 on the parameters' device


def init(params: dict[str, torch.Tensor]) -> AdamState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    device = next(iter(params.values())).device
    return AdamState(m=zeros, v={k: z.clone() for k, z in zeros.items()},
                     step=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def step(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
         state: AdamState, hp: AdamParams) -> None:
    """One Adam step, in place on ``params`` and ``state``."""
    state.step += 1
    t = state.step.float()
    step_size = hp.lr * torch.sqrt(1.0 - hp.beta2 ** t) / (1.0 - hp.beta1 ** t)
    for k, p in params.items():
        g = grads[k].float()
        m, v = state.m[k], state.v[k]
        m.mul_(hp.beta1).add_((1.0 - hp.beta1) * g)
        v.mul_(hp.beta2).add_((1.0 - hp.beta2) * g * g)
        p.copy_(p.float() - step_size * m / (torch.sqrt(v) + hp.eps))
