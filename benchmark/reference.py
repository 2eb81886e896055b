"""What every family's plain reference shares: TF32 rounding for the control,
sparse CSR tensors from generated arrays, Glorot weights and the reference
program's Adam step. It imports nothing of the program and nothing of JAX;
a family's reference (``benchmark/families/<family>.py`` ``follow``) is
written in plain float32 PyTorch with TF32 off on top of it.

``precision='tf32'`` is the control of the comparison: every dense product's
operands rounded to TF32 (10 mantissa bits, to nearest even), the precision
a float32 product runs in on this card with TF32 on; the sparse products stay
float32, as cuSPARSE has no TF32 mode.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
PRECISIONS = ("float32", "tf32")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to nearest even at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b``; at 'tf32' a dense product's operands are rounded to TF32 first."""
    if a.layout == torch.sparse_csr:
        return a @ b
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b


def use_float32() -> None:
    """Dense products in float32, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray, shape,
        device) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sparse CSR is "in beta state"
        return torch.sparse_csr_tensor(
            torch.from_numpy(indptr.astype(np.int64)), torch.from_numpy(indices.astype(np.int64)),
            torch.from_numpy(values.astype(np.float32)), size=shape,
            check_invariants=False).to(device)


def csr_t(crow: torch.Tensor, cols: torch.Tensor, values: torch.Tensor, shape) -> torch.Tensor:
    """A sparse CSR tensor from tensors already on their device."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sparse CSR is "in beta state"
        return torch.sparse_csr_tensor(crow, cols, values, size=shape, check_invariants=False)


def transpose_csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray, n_cols: int):
    """(row pointer, columns, values) of the transpose of a CSR matrix."""
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    t_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=n_cols), out=t_indptr[1:])
    return t_indptr, rows[order], values[order]


def glorot_weights(dims: tuple[int, ...], seed: int) -> list[torch.Tensor]:
    """Glorot uniform weights in (-a, a), a = sqrt(6/(fan_in+fan_out))
    (the reference program's variable.cpp), drawn in float32 layer by layer
    from one CPU ``torch.Generator`` seeded with the job's seed."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        a = (6.0 / (fan_in + fan_out)) ** 0.5
        out.append(torch.empty(fan_in, fan_out).uniform_(-a, a, generator=gen))
    return out


def adam_step(w: list[torch.Tensor], m: list[torch.Tensor], v: list[torch.Tensor],
              grads: list[torch.Tensor], t: int, lr: float) -> None:
    """Step ``t`` (from 1) of the reference program's Adam, in place: step size
    lr·sqrt(1-β2^t)/(1-β1^t), eps outside the root."""
    step_size = lr * (1.0 - ADAM_BETA2 ** t) ** 0.5 / (1.0 - ADAM_BETA1 ** t)
    for wi, mi, vi, g in zip(w, m, v, grads):
        mi.mul_(ADAM_BETA1).add_((1.0 - ADAM_BETA1) * g)
        vi.mul_(ADAM_BETA2).add_((1.0 - ADAM_BETA2) * g * g)
        wi.sub_(step_size * mi / (torch.sqrt(vi) + ADAM_EPS))
