"""GCNII's aggregation with its initial residual (Chen et al., "Simple and Deep
Graph Convolutional Networks", ICML 2020, arXiv:2007.02133, eq. 5):

    s = a·Â·h + b·h0        (a = 1 − α, b = α)

in one pass of kernel 3 over the ELL plan (ops/ell.py), its blended form
(``kernels.ell_blend``, csrc/ell_spmm.cu): the blend is taken in the store of
each output row, and in the reduction of the rows split into chunks, so that
s is written once and nothing else reads or writes an [N, d] tensor for it.
Its backward is dh = a·Âᵀ·g (the same kernel without h0, a scaled transposed
pass) and dh0 = b·g.

``blend`` is the single form; ``blend_pair`` the fused epoch's, the training
and the evaluation halves in one pass at the concatenated width (as
ops/graphsum.py ``graphsum_pair``), each half's h0 and s in a tensor of its
own, only the training half differentiated. A tensor on the CPU takes the
plain version (``blend_plain``): the ELL product's plain version, then the
blend in torch operations with the kernel's rounding (each product rounded,
then their sum). The graph must carry the ELL plan: GCNII runs on ``ell``
and ``pallas`` alone (models/gcnii.py).
"""

from __future__ import annotations

import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.data.graph import Graph
from cuda_gcn_torch.ops.ell import EllPlan, ell_spmm_plain


def blend_plain(plan: EllPlan, h: torch.Tensor, h0s, a: float, b: float, halves: int = 1):
    """Plain version of ``kernels.ell_blend``: the product, cut into ``halves``
    column halves, each a·(its half) + b·(its h0), or a·(its half) where h0s is
    None."""
    p = ell_spmm_plain(plan, h)
    parts = p.chunk(halves, dim=1) if halves > 1 else (p,)
    if h0s is None:
        outs = tuple(a * q for q in parts)
    else:
        outs = tuple(a * q + b * h0 for q, h0 in zip(parts, h0s))
    return outs if halves > 1 else outs[0]


def _pass(plan: EllPlan, h: torch.Tensor, h0s, a: float, b: float, halves: int = 1):
    if h.device.type == "cpu":
        return blend_plain(plan, h, h0s, a, b, halves)
    h0 = None if h0s is None else (h0s[0] if halves == 1 else h0s)
    return kernels.ell_blend(plan.work_beg, plan.work_len, plan.work_dst, plan.split_rows,
                             plan.split_ptr, plan.cols, plan.coef, h, h0, plan.n_nodes,
                             plan.n_partials, a, b, halves)


def _transposed(g: torch.Tensor, graph: Graph, a: float) -> torch.Tensor:
    """a·Âᵀ·g; a symmetric Â is its own transpose."""
    return _pass(graph.ell if graph.symmetric else graph.ell_t, g.contiguous(), None, a, 0.0)


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, h0, graph, a, b):
        ctx.graph, ctx.a, ctx.b = graph, a, b
        return _pass(graph.ell, h.contiguous(), (h0.contiguous(),), a, b)

    @staticmethod
    def backward(ctx, g):
        return _transposed(g, ctx.graph, ctx.a), ctx.b * g, None, None, None


def blend(h: torch.Tensor, h0: torch.Tensor, graph: Graph, a: float, b: float) -> torch.Tensor:
    """s = a·Â·h + b·h0 for h, h0 of shape [N, d] (f32)."""
    return _Blend.apply(h, h0, graph, a, b)


def side_by_side(ht: torch.Tensor, he: torch.Tensor) -> torch.Tensor | None:
    """The [N, 2d] tensor whose column halves are ht and he [N, d], where they
    lie so in one buffer (GCNII's epilogue writes them so: ops/epilogue.py);
    else None."""
    n, d = ht.shape
    if (he.shape == ht.shape and he.dtype == ht.dtype and ht.stride() == he.stride() == (2 * d, 1)
            and he.data_ptr() == ht.data_ptr() + d * ht.element_size()
            and he.untyped_storage().data_ptr() == ht.untyped_storage().data_ptr()):
        return ht.as_strided((n, 2 * d), (2 * d, 1))
    return None


class _BlendPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ht, he, h0t, h0e, graph, a, b):
        ctx.graph, ctx.a, ctx.b = graph, a, b
        both = side_by_side(ht, he)
        st, se = _pass(graph.ell, torch.cat([ht, he], dim=1) if both is None else both,
                       (h0t.contiguous(), h0e.contiguous()), a, b, 2)
        ctx.mark_non_differentiable(se)
        ctx.set_materialize_grads(False)  # se has none: no [N, d] of zeros for it
        return st, se

    @staticmethod
    def backward(ctx, g_t, g_e):
        if g_t is None:
            return (None,) * 7
        return _transposed(g_t, ctx.graph, ctx.a), None, ctx.b * g_t, None, None, None, None


def blend_pair(ht: torch.Tensor, he: torch.Tensor, h0t: torch.Tensor, h0e: torch.Tensor,
               graph: Graph, a: float, b: float):
    """(a·Â·ht + b·h0t, a·Â·he + b·h0e) in one pass at the concatenated width
    (ht and he read in place where they lie ``side_by_side``); only the
    training half (ht, h0t) is differentiated, the evaluation half is
    detached."""
    st, se = _BlendPair.apply(ht, he.detach(), h0t, h0e.detach(), graph, a, b)
    return st, se.detach()
