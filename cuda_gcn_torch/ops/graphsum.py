"""GraphSum: out = Â·H, with backward Âᵀ·G (cuda_gcn_tpu/ops/graphsum.py).

Dispatch by backend:

* ``bsr``     — kernel 1 (dense tiles, ops/bsr.py) writes the tile part, then
  kernel 2 (ops/residual.py) adds the residual edges into it;
* ``segment`` — kernel 2 over every edge;
* ``ell``, ``pallas`` — kernel 3 (ops/ell.py) over the ELL plan. The JAX
  package runs ``pallas`` through its Pallas kernel only when h fits VMEM and
  ``ell`` through XLA (:312-331); on the card both launch kernel 3 at any size;
* ``dense``   — ``torch.mm`` on the dense Â cast to h's type, as the JAX
  package leaves it to XLA (:326-327).

Every backend returns h's type (f32 or bf16) and sums in f32, as the JAX
package's graphsum does (:99,154,247); the bsr pass stores the tile part in
h's type and kernel 2 adds the residual to it in f32 (:303).

A symmetric graph routes the backward through the forward structures
(:335-352); an asymmetric one runs over the transposed tile plan and the
transposed residual CSR, or the transposed ELL plan.

``RectGraph``/``rect_graphsum`` (:357-445) are the sharded trainer's
operators out[n_out, d] = A·h[n_in, d]: a part's square interior, which is a
``Graph`` on ``bsr`` (kernel 1 tiles and the kernel 2 residual, both
orientations built) or on ``segment``, so that ``_apply`` serves it as it
is; and the rectangular boundary, a residual CSR of ``n_out`` rows over
``n_in`` halo rows with its transpose (kernel 2 both ways).
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_gcn_torch.data.graph import Graph, ResidualCSR
from cuda_gcn_torch.ops.bsr import bsr_tile_contract
from cuda_gcn_torch.ops.ell import ell_spmm
from cuda_gcn_torch.ops.residual import residual_spmm


def _residual(h, resid: ResidualCSR, out=None):
    return residual_spmm(resid.row_ptr, resid.cols, resid.coef, h, out, work=resid.work)


def _bsr_apply(h, graph: Graph, transpose: bool):
    if transpose:
        rows, cols, plan = graph.tile_cols, graph.tile_rows, graph.plan_t
    else:
        rows, cols, plan = graph.tile_rows, graph.tile_cols, graph.plan
    if graph.num_tiles == 0:
        return _residual(h, graph.resid_t if transpose else graph.resid)
    out = bsr_tile_contract(graph.tiles, rows, cols, h, graph.n_nodes,
                            graph.t_blocks, transpose=transpose, plan=plan)
    return _residual(h, graph.resid_t if transpose else graph.resid, out)


def _apply(h: torch.Tensor, graph: Graph, transpose: bool) -> torch.Tensor:
    h = h.contiguous()
    if graph.backend == "bsr":
        return _bsr_apply(h, graph, transpose)
    if graph.backend in ("ell", "pallas"):
        return ell_spmm(graph.ell_t if transpose else graph.ell, h)
    if graph.backend == "dense":
        adj = graph.adj if graph.adj.dtype == h.dtype else graph.adj.to(h.dtype)
        return torch.mm(adj.t() if transpose else adj, h)
    return _residual(h, graph.resid_t if transpose else graph.resid)


def forward(h: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Â·H without autograd."""
    return _apply(h, graph, transpose=False)


def transpose_forward(g: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Âᵀ·G; a symmetric Â is its own transpose."""
    return _apply(g, graph, transpose=not graph.symmetric)


class GraphSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, graph):
        ctx.graph = graph
        return forward(h, graph)

    @staticmethod
    def backward(ctx, g):
        return transpose_forward(g, ctx.graph), None


def graphsum(h: torch.Tensor, graph: Graph) -> torch.Tensor:
    """out = Â·H for H of shape [N, d]."""
    return GraphSum.apply(h, graph)


class _GraphSumPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zt, ze, graph):
        ctx.graph = graph
        d = zt.shape[1]
        both = forward(torch.cat([zt, ze], dim=1), graph)
        out_t, out_e = both[:, :d].contiguous(), both[:, d:].contiguous()
        ctx.mark_non_differentiable(out_e)
        return out_t, out_e

    @staticmethod
    def backward(ctx, g_t, g_e):
        return transpose_forward(g_t, ctx.graph), None, None


def graphsum_pair(zt: torch.Tensor, ze: torch.Tensor, graph: Graph):
    """(Â·zt, Â·ze) in one adjacency pass at the concatenated width
    (cuda_gcn_tpu/ops/graphsum.py:474-514). Only the train half is
    differentiated, so the backward pass runs at train width; the eval half
    is detached."""
    out_t, out_e = _GraphSumPair.apply(zt, ze.detach(), graph)
    return out_t, out_e.detach()


@dataclasses.dataclass
class RectGraph:
    """out[n_out, d] = A · h[n_in, d]: ``square`` (a Graph, n_out == n_in),
    or the residual CSR ``resid`` of n_out rows over n_in columns with its
    transpose ``resid_t`` of n_in rows."""

    n_out: int
    n_in: int
    square: Graph | None = None
    resid: ResidualCSR | None = None
    resid_t: ResidualCSR | None = None


def rect_apply(h: torch.Tensor, rg: RectGraph, transpose: bool,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """A·h, or Aᵀ·h with ``transpose`` (h of n_out rows then), in h's type; a
    rectangular operator adds in place to ``out`` when it is given."""
    h = h.contiguous()
    if rg.square is not None:
        res = _apply(h, rg.square, transpose)
        return res if out is None else out.add_(res)
    return _residual(h, rg.resid_t if transpose else rg.resid, out)


class _RectGraphSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, rg):
        ctx.rg = rg
        return rect_apply(h, rg, transpose=False)

    @staticmethod
    def backward(ctx, g):
        return rect_apply(g, ctx.rg, transpose=True), None


def rect_graphsum(h: torch.Tensor, rg: RectGraph) -> torch.Tensor:
    """out[n_out, d] = A · h for h of shape [n_in, d]; the backward is Aᵀ·g."""
    return _RectGraphSum.apply(h, rg)
