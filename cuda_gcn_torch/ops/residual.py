"""Residual half of the adjacency pass — kernel 2 (csrc/csr_spmm.cu).

out[i] += Σ_{e in row i} coef[e] · h[cols[e]] over a CSR of edges. In the JAX
package this is XLA, not Pallas: ``_segment_apply``
(cuda_gcn_tpu/ops/graphsum.py:42-44) and, above 49,152 nodes,
``_blocked2d_apply`` (:136-154) over the flat piece layout. It is a kernel here
because it is the other half of every adjacency pass, and because
``index_add_`` on the card uses atomics and is not deterministic. The kernel
walks a ``WorkList`` over the CSR rows (ops/ell.py), built once with the graph.

A tensor on the CPU takes the plain PyTorch version below; a CUDA tensor
launches the kernel (cuda_gcn_torch.kernels) or raises.
"""

from __future__ import annotations

import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.ops.ell import WorkList


def residual_spmm_plain(row_ptr, cols, coef, h, out=None) -> torch.Tensor:
    """Plain version: gather, scale and ``index_add_`` in f32, one cast to h's
    type. With ``out`` the f32 sum is added to it in place (out + Σ, as
    dense_part + resid in JAX), rounded once to out's type. The CSR has
    ``row_ptr.numel() - 1`` rows and its ``cols`` index the rows of h, of
    which there may be another number (a rectangular operator)."""
    n, d = row_ptr.numel() - 1, h.shape[1]
    rows = torch.repeat_interleave(torch.arange(n, device=h.device),
                                   torch.diff(row_ptr.long()))
    resid = torch.zeros(n, d, dtype=torch.float32, device=h.device)
    resid.index_add_(0, rows, h[cols.long()].float() * coef.float()[:, None])
    if out is None:
        return resid.to(h.dtype)
    return out.add_(resid)


def residual_spmm(row_ptr, cols, coef, h, out=None,
                  work: WorkList | None = None) -> torch.Tensor:
    """Σ over the CSR rows of coef · h[col], summed in f32, in h's type; added
    in place to ``out`` when it is given (the kernel writes each row once, no
    atomics). ``work`` is
    ``csr_work_list(row_ptr)``, built once with the CSR (``ResidualCSR.work``);
    the kernel needs it, the plain version does not."""
    if h.device.type == "cpu":
        return residual_spmm_plain(row_ptr, cols, coef, h, out)
    if work is None:
        raise ValueError("residual_spmm on a device tensor needs the CSR's work list "
                         "(ops/ell.py csr_work_list)")
    return kernels.csr_spmm(work, cols, coef, h, int(row_ptr.numel()) - 1, out)
