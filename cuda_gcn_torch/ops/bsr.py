"""Dense-tile half of the BSR adjacency pass — kernel 1 (csrc/bsr_tile.cu).

out[n, d] = Σ_k A_k · h[block cols[k]] scattered to block rows[k], where A_k is
tile k ([tb, tb]) or, with ``transpose``, its transpose. This replaces the TPU
kernels ``_bsr_kernel`` and ``_bsr_kernel_resident``
(cuda_gcn_tpu/ops/pallas_bsr.py:65,120) and the XLA einsum path
``graphsum._tile_contract`` + ``_dense_tile_part``
(cuda_gcn_tpu/ops/graphsum.py:166-247). ``rows`` are the output block of each
tile and ``cols`` the block of ``h`` it reads, as in ``_dense_tile_part``: the
transpose orientation is called with the tile rows and cols swapped.

Numerics on the card. For bf16 tiles the kernel runs on the tensor cores and
still gives the f32 result: an f32 number is exactly the sum of three bf16
numbers (24 = 8 + 8 + 8 mantissa bits, ``split_bf16x3``), a bf16 x bf16 product
is exact in f32, so A·h = A·hi + A·mid + A·lo with f32 accumulators differs from
the f32 product only in the order and rounding of the additions; the kernel
adds each tile's sums into f32 registers, so that the tensor cores' rounding
of a running sum does not grow with a block row's length.
``bsr_tile_contract_split_plain`` restates that arithmetic in PyTorch. bf16 h
(compute_dtype='bfloat16') is its own one bf16 part, and the result is
rounded to bf16 once; f32 tiles are rounded to bf16 for bf16 h, as the TPU
kernel casts its tiles to h's type (cuda_gcn_tpu/ops/pallas_bsr.py:79).

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
    # (T,) int32: the block rows, most tiles first (stable). CTAs start in this
    # order, so the long rows do not form the tail; None starts them in row order.
    by_load: torch.Tensor | None = None


def tile_plan(rows: torch.Tensor, cols: torch.Tensor, t_blocks: int) -> TilePlan:
    """Group tiles by output block ``rows`` (stable, so sorted rows keep their
    order); ``cols`` give the block of h each tile reads."""
    rows = rows.long()
    order = torch.argsort(rows, stable=True)
    ptr = torch.zeros(t_blocks + 1, dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=t_blocks), 0)
    by_load = torch.argsort(torch.diff(ptr), descending=True, stable=True)
    return TilePlan(ptr=ptr.int(), order=order.int(), hblk=cols.long()[order].int(),
                    by_load=by_load.int())


def split_bf16x3(h: torch.Tensor):
    """(hi, mid, lo) in bf16 with hi + mid + lo == h: hi = bf16(h), mid =
    bf16(h - hi), lo = bf16(h - hi - mid), each rounded to nearest even. The
    differences are exact in f32 and each rounding takes at least 8 of the 24
    mantissa bits, so the sum is h bit for bit for every finite f32 whose last
    mantissa bit is at least bf16's smallest subnormal, 2^-133: from |h| >= 2^-110
    on always; below that, lo loses the bits under 2^-133. An infinite h gives
    a NaN mid (inf - inf)."""
    h = h.float()
    hi = h.to(torch.bfloat16)
    rest = h - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _tiles_f32(tiles, h_dtype) -> torch.Tensor:
    """The tiles in f32 as the kernel multiplies them: rounded to h's type
    first when h is bf16."""
    return (tiles.to(h_dtype) if h_dtype == torch.bfloat16 else tiles).to(torch.float32)


def bsr_tile_contract_plain(tiles, rows, cols, h, n: int, t_blocks: int,
                            transpose: bool = False) -> torch.Tensor:
    """Plain version: gather the h blocks, batched product in f32 (tiles
    upcast), ``index_add_`` into block rows that no tile visits stay zero,
    one cast to h's type at the end."""
    k, tb = int(tiles.shape[0]), int(tiles.shape[1])
    d = h.shape[1]
    if k == 0:
        return torch.zeros(n, d, dtype=h.dtype, device=h.device)
    hp = torch.zeros(t_blocks * tb, d, dtype=torch.float32, device=h.device)
    hp[:n] = h
    gathered = hp.view(t_blocks, tb, d)[cols.long()]   # [K, tb, d]
    a = _tiles_f32(tiles, h.dtype)
    if transpose:
        a = a.transpose(1, 2)
    prod = torch.bmm(a, gathered)                      # [K, tb, d]
    out = torch.zeros(t_blocks, tb, d, dtype=torch.float32, device=h.device)
    out.index_add_(0, rows.long(), prod)
    return out.view(t_blocks * tb, d)[:n].to(h.dtype)


def bsr_tile_contract_split_plain(tiles, rows, cols, h, n: int, t_blocks: int,
                                  transpose: bool = False) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: the three bf16
    parts of h (``split_bf16x3``), each upcast and multiplied by the upcast
    tiles in f32, the three products added, then ``index_add_`` as in the plain
    version."""
    k, tb = int(tiles.shape[0]), int(tiles.shape[1])
    d = h.shape[1]
    if k == 0:
        return torch.zeros(n, d, dtype=h.dtype, device=h.device)
    a = tiles.to(torch.float32)
    if transpose:
        a = a.transpose(1, 2)
    prod = torch.zeros(k, tb, d, dtype=torch.float32, device=h.device)
    for part in split_bf16x3(h):
        hp = torch.zeros(t_blocks * tb, d, dtype=torch.float32, device=h.device)
        hp[:n] = part.float()
        prod += torch.bmm(a, hp.view(t_blocks, tb, d)[cols.long()])
    out = torch.zeros(t_blocks, tb, d, dtype=torch.float32, device=h.device)
    out.index_add_(0, rows.long(), prod)
    return out.view(t_blocks * tb, d)[:n].to(h.dtype)


def bsr_tile_contract(tiles, rows, cols, h, n: int, t_blocks: int,
                      transpose: bool = False,
                      plan: TilePlan | None = None) -> torch.Tensor:
    """Dense-tile contribution [n, d] in h's type (f32 or bf16), summed in
    f32. ``plan`` is ``tile_plan(rows, cols, t_blocks)``, precomputed by
    build_graph; it is built here when absent."""
    if h.device.type == "cpu":
        return bsr_tile_contract_plain(tiles, rows, cols, h, n, t_blocks, transpose)
    if plan is None:
        plan = tile_plan(rows, cols, t_blocks)
    return kernels.bsr_tile(tiles, plan.ptr, plan.order, plan.hblk, h, n,
                            t_blocks, transpose, row_order=plan.by_load)
