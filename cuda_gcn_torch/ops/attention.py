"""The GAT's multi-head graph attention (Veličković et al., arXiv:1710.10903,
eqs. 1-4) over the ELL plan: csrc/gat_attention.cu on the card, the plain
PyTorch version below on the CPU.

For z [N, K·F'] (K heads of F' features side by side) and the scores
sl = ⟨z_i, a_l⟩ and sr = ⟨z_j, a_r⟩ [N, K] of each head:

    e_ij = LeakyReLU(sl_i + sr_j)                 for the slots j of row i
    α_ij = exp(e_ij - max_j e_ij) / Σ_j exp(...)  the softmax over the row
    out_i = Σ_j dropout(α_ij) · z_j               head by head, [N, K·F']

A row of z, out and their gradients holds head k's F' features at k·LD, LD >=
F' (``fh``: F'; None: no padding): the GAT pads a head whose F' is no
multiple of 4 with zeros to LD = ``head_stride(F')`` floats, so that the
kernels load its rows in 16-byte pieces. The padding of z and g must hold 0:
the kernels take it as features (a zero adds nothing), the plain versions
leave it out; out and dz hold 0 there.

The rows are Â's (the self-loop included), in the graph's ELL plan; the
backward's transpose aggregation runs over the plan of Âᵀ (Â's own for a
symmetric pattern) with the reverse-edge map (ops/ell.py ``EdgeMap``), so
that nothing is scattered. The dropout of α is drawn in the kernels, keyed by
two int64 that ``attention`` draws on the device from the job's generator
(as the dense layer-0 kernel's are, ops/matmul.py ``_Layer0Pair``): a
replayed CUDA graph draws a fresh mask, and the host reads nothing. The mask
of forward slot s and head k is ``attention_keep``'s; a kept weight is scaled
by 1/(1 - p).

What the autograd Function keeps for the backward is z, sl, sr, each row's
max and sum [N, K, 2] and the seeds: every weight is recomputed where it is
needed, and no [S, K] tensor is made (671 MB at synth-reddit's 21M slots and
8 heads). Its backward gives the gradients of z (the aggregation's part),
sl and sr; the parts that pass through sl and sr into z and the attention
vectors are ATen's, in the model (models/gat.py).

A tensor on the CPU takes the plain versions (an edge list, ``index_add_``),
one a kernel, in the kernels' formulas; a CUDA tensor launches the kernels or
raises.
"""

from __future__ import annotations

import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.ops.ell import EdgeMap
from cuda_gcn_torch.ops.matmul import philox_keep


def attention_keep(seeds, slots: torch.Tensor, heads: int, rate: float) -> torch.Tensor:
    """The attention dropout's mask of the forward plan's ``slots``, [len, K]
    bool on their device: head k of slot s keeps its weight where word k % 4
    of the Philox4x32-10 call under the key seeds[0], at the counter (s·⌈K/4⌉
    + k/4 as two words, then the offset seeds[1] as two), lies below
    ``kernels.gat_keep(rate)``'s threshold."""
    return philox_keep(seeds, slots, heads, kernels.gat_keep(rate)[2])


def head_stride(fh: int) -> int:
    """LD, the floats a head of F' = ``fh`` features takes in a row: F' rounded
    up to a multiple of 4 (16 bytes of f32)."""
    return -(-fh // 4) * 4


def _heads(t: torch.Tensor, heads: int, fh: int | None) -> torch.Tensor:
    """t [N, K·LD] as [N, K, F']: each head's features, its padding left out."""
    return t.view(t.shape[0], heads, -1)[..., :fh]


def _padded(t3: torch.Tensor, ld: int) -> torch.Tensor:
    """[N, K, F'] as [N, K·LD], zero past each head's F'."""
    n, k, fh = t3.shape
    return torch.nn.functional.pad(t3, (0, ld - fh)).view(n, k * ld)


def _leaky(e: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(e > 0, e, e * slope)


def _weights(emap: EdgeMap, heads: int, rate: float, seeds, dtype):
    """(slot, row, col) of the forward plan's edges and each edge-head's kept
    weight scale [E, K]: 1/(1 - p) where kept, 0 where dropped, 1 without
    dropout."""
    slot, row, col = emap.edges()
    if seeds is None:
        return slot, row, col, torch.ones(len(slot), heads, dtype=dtype, device=slot.device)
    inv_q = kernels.gat_keep(rate)[1]
    keep = attention_keep(seeds.tolist(), slot, heads, rate)
    return slot, row, col, torch.where(keep, inv_q, 0.0).to(dtype)


def attention_forward_plain(emap: EdgeMap, z, sl, sr, heads: int, slope: float, rate: float,
                            seeds=None, *, fh: int | None = None):
    """Plain version of ``kernels.gat_forward``: (out [N, K·LD], each row's
    max and sum [N, K, 2])."""
    n, d = z.shape
    _, row, col, scale = _weights(emap, heads, rate, seeds, z.dtype)
    e = _leaky(sl[row] + sr[col], slope)
    m = z.new_full((n, heads), float("-inf")).scatter_reduce(
        0, row[:, None].expand(-1, heads), e, "amax")
    p = torch.exp(e - m[row])
    den = z.new_zeros(n, heads).index_add_(0, row, p)
    w = p / den[row] * scale
    z3 = _heads(z, heads, fh)
    out = torch.zeros_like(z3).index_add_(0, row, w[..., None] * z3[col])
    return _padded(out, d // heads), torch.stack([m, den], dim=-1)


def attention_rows_plain(emap: EdgeMap, g, z, sl, sr, stats, heads: int, slope: float,
                         rate: float, seeds=None, *, fh: int | None = None):
    """Plain version of ``kernels.gat_rows``: (node [N, K, 4] = (sl, the row's
    max, the reciprocal of its sum, A = Σ_j α·da), dsl [N, K]), da the
    gradient of a dropped weight, ⟨g_i, z_j⟩ head by head, times its scale;
    a weight is exp(e - max) times the reciprocal, as in the kernels."""
    n = z.shape[0]
    _, row, col, scale = _weights(emap, heads, rate, seeds, z.dtype)
    ep = sl[row] + sr[col]
    lam = torch.where(ep > 0, ep.new_ones(()), ep.new_full((), slope))
    rden = 1.0 / stats[..., 1]
    alpha = torch.exp(_leaky(ep, slope) - stats[row, :, 0]) * rden[row]
    da = (_heads(g, heads, fh)[row] * _heads(z, heads, fh)[col]).sum(-1) * scale
    a_sum = z.new_zeros(n, heads).index_add_(0, row, alpha * da)
    dsl = z.new_zeros(n, heads).index_add_(0, row, alpha * (da - a_sum[row]) * lam)
    return torch.stack([sl, stats[..., 0], rden, a_sum], dim=-1), dsl


def attention_cols_plain(emap: EdgeMap, g, z, sr, node, heads: int, slope: float, rate: float,
                         seeds=None, *, fh: int | None = None):
    """Plain version of ``kernels.gat_cols``: (dz [N, K·LD], the aggregation's
    part of z's gradient, dsr [N, K]), each row i's terms read from ``node``."""
    n, d = z.shape
    _, row, col, scale = _weights(emap, heads, rate, seeds, z.dtype)
    nd = node[row]
    ep = nd[..., 0] + sr[col]
    lam = torch.where(ep > 0, ep.new_ones(()), ep.new_full((), slope))
    alpha = torch.exp(_leaky(ep, slope) - nd[..., 1]) * nd[..., 2]
    g3 = _heads(g, heads, fh)
    da = (g3[row] * _heads(z, heads, fh)[col]).sum(-1) * scale
    dsr = z.new_zeros(n, heads).index_add_(0, col, alpha * (da - nd[..., 3]) * lam)
    dz = torch.zeros_like(g3).index_add_(0, col, (alpha * scale)[..., None] * g3[row])
    return _padded(dz, d // heads), dsr


def attention_backward_plain(emap: EdgeMap, g, z, sl, sr, stats, heads: int, slope: float,
                             rate: float, seeds=None, *, fh: int | None = None):
    """Both passes of the backward, plain: (dz, dsl, dsr), the gradients of z
    (the aggregation's part), sl and sr."""
    node, dsl = attention_rows_plain(emap, g, z, sl, sr, stats, heads, slope, rate, seeds,
                                     fh=fh)
    dz, dsr = attention_cols_plain(emap, g, z, sr, node, heads, slope, rate, seeds, fh=fh)
    return dz, dsl, dsr


def _forward(emap, z, sl, sr, heads, slope, rate, seeds, with_stats, fh=None):
    if z.device.type == "cpu":
        return attention_forward_plain(emap, z, sl, sr, heads, slope, rate, seeds, fh=fh)
    return kernels.gat_forward(emap.plan, emap.partial_rows, z, sl, sr, heads, slope, rate,
                               seeds, with_stats)


def _rows(emap, g, z, sl, sr, stats, heads, slope, rate, seeds, fh=None):
    if z.device.type == "cpu":
        return attention_rows_plain(emap, g, z, sl, sr, stats, heads, slope, rate, seeds, fh=fh)
    return kernels.gat_rows(emap.plan, emap.partial_rows, g, z, sl, sr, stats, heads, slope,
                            rate, seeds)


def _cols(emap, g, z, sr, node, heads, slope, rate, seeds, fh=None):
    if z.device.type == "cpu":
        return attention_cols_plain(emap, g, z, sr, node, heads, slope, rate, seeds, fh=fh)
    return kernels.gat_cols(emap.plan_t, emap.partial_rows_t, emap.rev, g, z, sr, node, heads,
                            slope, rate, seeds)


class _Attention(torch.autograd.Function):
    """The attention, differentiated in z, sl and sr."""

    @staticmethod
    def forward(ctx, z, sl, sr, emap, heads, fh, slope, rate, seeds):
        z, sl, sr = z.contiguous(), sl.contiguous(), sr.contiguous()
        out, stats = _forward(emap, z, sl, sr, heads, slope, rate, seeds, True, fh)
        ctx.save_for_backward(z, sl, sr, stats, seeds)
        ctx.emap, ctx.heads, ctx.fh, ctx.slope, ctx.rate = emap, heads, fh, slope, rate
        return out

    @staticmethod
    def backward(ctx, g):
        z, sl, sr, stats, seeds = ctx.saved_tensors
        emap, heads, fh, slope, rate = ctx.emap, ctx.heads, ctx.fh, ctx.slope, ctx.rate
        g = g.contiguous()
        node, dsl = _rows(emap, g, z, sl, sr, stats, heads, slope, rate, seeds, fh)
        dz, dsr = _cols(emap, g, z, sr, node, heads, slope, rate, seeds, fh)
        return dz, dsl, dsr, None, None, None, None, None, None


def attention(z: torch.Tensor, sl: torch.Tensor, sr: torch.Tensor, emap: EdgeMap,
              heads: int, slope: float, rate: float, generator: torch.Generator | None,
              training: bool, *, fh: int | None = None) -> torch.Tensor:
    """out [N, K·LD] of z [N, K·LD] (``fh`` features a head; None: LD) and
    the scores sl, sr [N, K] over the graph's ``EdgeMap``, zero in each head's
    padding; in training at a rate above 0 the weights take dropout, its seeds
    drawn on the device from ``generator``. Differentiated in z, sl and sr
    where one of them requires a gradient."""
    seeds = None
    if training and rate > 0.0:
        seeds = torch.empty(2, dtype=torch.int64, device=z.device).random_(generator=generator)
    if torch.is_grad_enabled() and (z.requires_grad or sl.requires_grad or sr.requires_grad):
        return _Attention.apply(z, sl, sr, emap, heads, fh, slope, rate, seeds)
    return _forward(emap, z.contiguous(), sl.contiguous(), sr.contiguous(), heads, slope,
                    rate, seeds, False, fh)[0]
