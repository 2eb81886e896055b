"""Dense-tile half of the BSR adjacency pass — kernel 1 (csrc/bsr_tile.cu).

out[n, d] = Σ_k A_k · h[block cols[k]] scattered to block rows[k], where A_k is
tile k ([tb, tb]) or, with ``transpose``, its transpose. This replaces the TPU
kernels ``_bsr_kernel`` and ``_bsr_kernel_resident``
(cuda_gcn_tpu/ops/pallas_bsr.py:65,120) and the XLA einsum path
``graphsum._tile_contract`` + ``_dense_tile_part``
(cuda_gcn_tpu/ops/graphsum.py:166-247). ``rows`` are the output block of each
tile and ``cols`` the block of ``h`` it reads, as in ``_dense_tile_part``: the
transpose orientation is called with the tile rows and cols swapped.

A tensor on the CPU takes the plain PyTorch version below; a CUDA tensor
launches the kernel (cuda_gcn_torch.kernels) or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from cuda_gcn_torch import kernels


@dataclasses.dataclass
class TilePlan:
    """Tiles grouped by output block row, for the kernel's CTA-per-row loop."""

    ptr: torch.Tensor    # (T+1,) int32: slots [ptr[r], ptr[r+1]) feed block row r
    order: torch.Tensor  # (K,) int32: tile id of each slot
    hblk: torch.Tensor   # (K,) int32: block of h that each slot reads


def tile_plan(rows: torch.Tensor, cols: torch.Tensor, t_blocks: int) -> TilePlan:
    """Group tiles by output block ``rows`` (stable, so sorted rows keep their
    order); ``cols`` give the block of h each tile reads."""
    rows = rows.long()
    order = torch.argsort(rows, stable=True)
    ptr = torch.zeros(t_blocks + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=t_blocks), 0)
    return TilePlan(ptr=ptr.int(), order=order.int(), hblk=cols.long()[order].int())


def bsr_tile_contract_plain(tiles, rows, cols, h, n: int, t_blocks: int,
                            transpose: bool = False) -> torch.Tensor:
    """Plain version: gather the h blocks, batched product in f32 (tiles
    upcast), ``index_add_`` into block rows that no tile visits stay zero."""
    k, tb = int(tiles.shape[0]), int(tiles.shape[1])
    d = h.shape[1]
    if k == 0:
        return torch.zeros(n, d, dtype=h.dtype, device=h.device)
    hp = torch.zeros(t_blocks * tb, d, dtype=torch.float32, device=h.device)
    hp[:n] = h
    gathered = hp.view(t_blocks, tb, d)[cols.long()]   # [K, tb, d]
    a = tiles.to(torch.float32)
    if transpose:
        a = a.transpose(1, 2)
    prod = torch.bmm(a, gathered)                      # [K, tb, d]
    out = torch.zeros(t_blocks, tb, d, dtype=torch.float32, device=h.device)
    out.index_add_(0, rows.long(), prod)
    return out.view(t_blocks * tb, d)[:n].to(h.dtype)


def bsr_tile_contract(tiles, rows, cols, h, n: int, t_blocks: int,
                      transpose: bool = False,
                      plan: TilePlan | None = None) -> torch.Tensor:
    """Dense-tile contribution [n, d] in f32. ``plan`` is ``tile_plan(rows,
    cols, t_blocks)``, precomputed by build_graph; it is built here when
    absent."""
    if h.device.type == "cpu":
        return bsr_tile_contract_plain(tiles, rows, cols, h, n, t_blocks, transpose)
    if plan is None:
        plan = tile_plan(rows, cols, t_blocks)
    return kernels.bsr_tile(tiles, plan.ptr, plan.order, plan.hblk, h, n,
                            t_blocks, transpose)
