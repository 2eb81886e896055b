"""Feature-transform matmuls (cuda_gcn_tpu/ops/matmul.py:28-64): dense, and
sparse over the CSR feature matrix as the reference program does
(``SparseMatmul``, src/seq/module.cpp:47-77).

``dense_matmul`` is a plain product outside any TPU kernel, so it stays a
library call where it stands alone: the eval-only product, the hidden layers,
and every product of a CPU tensor. device.resolve_device turns TF32 and
reduced-precision bf16 reductions off, so f32 runs in full f32 and bf16 sums in
f32. Its result is in x's type (cuda_gcn_tpu/ops/matmul.py:52). Where the JAX
package multiplies bf16 x by f32 W (compute bf16, param f32), it promotes
inside the dot to an f32 product of bf16 x and rounds it to bf16; here W is
rounded to bf16 instead and the product is one bf16 GEMM with f32 sums: it
reads bf16 x once, with no [N, F] f32 copy of it (561 MB on synth-reddit), and
differs from JAX's by about one rounding of W.

``layer0_dense_pair`` is layer 0 on dense x: dropout(x) @ W and, for the fused
epoch's pair, x @ W. In training on the card it is one launch of the dense
layer-0 kernel (csrc/layer0_pair.cu), which draws the mask itself (Philox,
``layer0_keep`` restates it), writes the dropped operand xd once and both
products from one read of x, with W rounded to x's type as above; the
backward's dW = xdᵀ·g stays a plain product of the saved xd, the one tensor of
x's shape kept for it. Without dropout (eval, or rate 0) and on the CPU it is
``ops/dropout.dropout`` and ``dense_matmul``, bit for bit the model's layer 0
before the kernel: the mask is torch's there, and the kernel's is another
draw of the same distribution.

``csr_matmul`` keeps X as CSR values: out[i] = Σ_{nnz j in row i} values[j] ·
W[cols[j]]. In the JAX package it is XLA (a gather and a sorted segment sum);
on the card it is the work the hand-written SpMM kernels already do, so
(with ``values`` cast to W's type, as the JAX package does, and the result in
W's type; f32 sums):

* forward, [n_rows, d]: kernel 2 (csrc/csr_spmm.cu) over the work list of X's
  rows, W as the gathered operand;
* backward dW = Xᵀ·g, [F, d]: kernel 3 (csrc/ell_spmm.cu) over the CSR of Xᵀ,
  with ``values[t_perm]`` so that a dropout applied to the forward's values
  reaches the transpose (as ``banded_matmul``'s ``t_idx`` does in the JAX
  package). Xᵀ has few, long rows (synth-reddit: 602 rows of about 6,800
  entries); the work list cuts them into 256-entry chunks whose partial sums
  are added in chunk order. One writer per row of dW and no atomics: this
  is the scatter the reference's CUDA backward races on
  (src/cuda/cuda_kernel.cu:112-122), and here it gives the same bits on
  every run;
* the gradient for ``values``, ⟨W[cols], g[rows]⟩, only when asked for, in
  plain tensor operations; training never asks.

Neither product has an [nnz, d] temporary or an N-row scatter, so the CSR
layout serves every node count. The JAX package switches to row bands
(``BandedFeatures``) from 2^19 rows on, to bound XLA's segment-sum output and
its gathered intermediate (cuda_gcn_tpu/ops/matmul.py:67-83); the port has no
such costs and keeps ``SparseFeatures`` at any size, with the JAX banded
result on the same input.

A tensor on the CPU takes ``csr_matmul_plain``; a CUDA tensor launches the
kernels or raises.

The sharded trainer gives each part its own ``SparseFeatures``
(``make_sparse_features_parts``, cuda_gcn_tpu/ops/matmul.py:200-293): the
part's feature rows, re-based to row 0 and padded to the part's ``block``
rows, so that the layer-0 product emits the part's [block, d] slab. The JAX
package's banded form of the same (``make_banded_features_parts``, :214) is
this CSR layout here, as for one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.ops.dropout import dropout
from cuda_gcn_torch.ops.ell import WorkList, csr_work_list

def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[N, F] @ [F, H] in x's type, summed in f32: W is cast to x's type."""
    return torch.matmul(x, w if w.dtype == x.dtype else w.to(x.dtype))


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def philox4x32(key, ctr: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Salmon et al., SC'11), as the dense layer-0 kernel draws
    it: ``ctr`` [..., 4] int64 of 32-bit words under ``key`` (two 32-bit ints)
    -> [..., 4] int64 of 32-bit words, on ``ctr``'s device. An int64 product
    keeps the low 64 bits of the 32 x 32-bit one (it wraps), whose high word
    the mask takes."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for _ in range(10):
        p0, p1 = c0 * _PHILOX_M[0], c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def philox_keep(seeds, rows: torch.Tensor, cols: int, thresh: int) -> torch.Tensor:
    """[len(rows), cols] bool on ``rows``' device: element (i, c) is kept where
    word c % 4 of the Philox call under the key seeds[0], at the counter
    (rows[i]·⌈cols/4⌉ + c/4 as two words, then the offset seeds[1] as two), lies
    below ``thresh``: the layout of the attention kernels' masks and of GCNII's
    epilogue's (ops/attention.py ``attention_keep``, ops/epilogue.py
    ``gcnii_keep``)."""
    seed, offset = (int(v) % 2**64 for v in seeds)
    calls = -(-cols // 4)
    c = (rows.long()[:, None] * calls
         + torch.arange(calls, dtype=torch.int64, device=rows.device)).reshape(-1)
    ctr = torch.stack([c & _U32, c >> 32, torch.full_like(c, offset & _U32),
                       torch.full_like(c, offset >> 32)], dim=-1)
    u = philox4x32((seed & _U32, seed >> 32), ctr).reshape(len(rows), calls * 4)
    return u[:, :cols] < thresh


def layer0_keep(seeds, n: int, f: int, rate: float, device=None) -> torch.Tensor:
    """The dense layer-0 kernel's mask, [n, f] bool on ``device``. Each
    element takes ``bits`` of a uniform (``kernels.dropout_keep(rate)``) and is
    kept where they lie below the threshold. A Philox call under the key
    seeds[0], at the counter (c as two words, then the offset seeds[1] as two),
    draws 128 bits: at 32 bits an element, call c = row·⌈f/4⌉ + column/4
    covers 4 columns of a row, a word each; at 8 bits, call c = pair·⌈f/8⌉ +
    column/8 covers 8 columns of rows r and r + 16 of a block of 32 (pair =
    block·16 + r), words 0-1 the lower row's, 2-3 the upper's, 4 columns a
    word, a byte each from the lowest."""
    seed, offset = (int(v) % 2**64 for v in seeds)
    _, _, _, thresh, bits = kernels.dropout_keep(rate)
    cols = 4 if bits == 32 else 8
    units = -(-f // cols)
    lines = n if bits == 32 else -(-n // 32) * 16  # rows, or row pairs
    g = torch.arange(lines * units, dtype=torch.int64, device=device)
    ctr = torch.stack([g & _U32, g >> 32, torch.full_like(g, offset & _U32),
                       torch.full_like(g, offset >> 32)], dim=-1)
    u = philox4x32((seed & _U32, seed >> 32), ctr).reshape(lines, units, 4)
    if bits == 32:
        vals = u.reshape(n, units * 4)
    else:
        u = torch.stack([(u >> (8 * e)) & 0xFF for e in range(4)], dim=-1)  # [pairs, units, 4, 4]
        u = u.reshape(-1, 16, units, 2, 8)  # [blocks, pair in block, units, lower/upper, column]
        vals = u.permute(0, 3, 1, 2, 4).reshape(-1, units * 8)[:n]  # row = block·32 + 16·upper + r
    return vals[:, :f] < thresh


def layer0_pair_plain(x, w, seeds, rate: float, with_eval: bool):
    """Plain version of ``kernels.layer0_pair``, on x's device: the kernel's
    mask (``layer0_keep``), xd = x / (1 - rate) in f32 where kept, rounded to
    x's type, and the products of xd and x with W (rounded to x's type) summed
    in f64 and rounded once to x's type: (xd, zt, ze or None)."""
    # q as a device tensor: ATen on the card multiplies by the reciprocal of a
    # host scalar, and divides by a tensor (correctly rounded)
    q = torch.tensor(kernels.dropout_keep(rate)[0], device=x.device)
    keep = layer0_keep(seeds.tolist(), x.shape[0], x.shape[1], rate, x.device)
    xd = torch.where(keep, x.float() / q, torch.zeros((), device=x.device)).to(x.dtype)
    wr = w.to(x.dtype).double()
    zt = (xd.double() @ wr).to(x.dtype)
    return xd, zt, (x.double() @ wr).to(x.dtype) if with_eval else None


class _Layer0Pair(torch.autograd.Function):
    """The dense layer-0 kernel, differentiated in W: it saves xd alone."""

    @staticmethod
    def forward(ctx, w, x, rate, generator, with_eval):
        # the kernel's Philox key and counter offset, drawn on the device from
        # the job's generator: a CUDA graph that registers it draws anew at
        # each replay, and the host reads nothing
        seeds = torch.empty(2, dtype=torch.int64, device=x.device).random_(generator=generator)
        xd, zt, ze = kernels.layer0_pair(x, w.detach().float(), seeds, rate, with_eval)
        ctx.save_for_backward(xd)
        ctx.w_dtype = w.dtype
        if ze is None:
            return zt
        ctx.mark_non_differentiable(ze)
        return zt, ze

    @staticmethod
    def backward(ctx, g, *_):
        (xd,) = ctx.saved_tensors
        return xd.t().mm(g).to(ctx.w_dtype), None, None, None, None


def layer0_dense_pair(x: torch.Tensor, w: torch.Tensor, rate: float,
                      generator: torch.Generator | None, training: bool,
                      with_eval: bool = False):
    """dropout(x) @ W for dense x [N, F], in x's type; with ``with_eval`` the
    pair (that, x @ W), the second without a gradient. A CUDA tensor in
    training at a rate above 0 takes the dense layer-0 kernel (W's gradient
    only: x is data); everything else ``dropout`` and ``dense_matmul``."""
    if x.device.type == "cpu" or not training or rate <= 0.0:
        zt = dense_matmul(dropout(x, rate, generator, training), w)
        if not with_eval:
            return zt
        with torch.no_grad():
            return zt, dense_matmul(x, w)
    if x.requires_grad:
        raise ValueError("layer0_dense_pair differentiates W only; x requires a gradient")
    return _Layer0Pair.apply(w, x, rate, generator, with_eval)


@dataclasses.dataclass
class SparseFeatures:
    """CSR feature matrix kept sparse on the device: the model's layer-0 input
    when ``GCNConfig.feature_matmul == 'sparse'``. ``values``, ``rows``,
    ``cols``, ``n_rows`` and ``n_cols`` are the JAX package's fields; the rest is
    what the kernels read, built once by ``from_csr``. Dropout applies to
    ``values`` (the reference's layer-0 dropout on nnz values, gcn.cpp:23)."""

    values: torch.Tensor   # (nnz,) float32, or bfloat16 for bf16 activations
    rows: torch.Tensor     # (nnz,) int32, sorted (CSR expansion)
    cols: torch.Tensor     # (nnz,) int32
    n_rows: int
    n_cols: int
    row_ptr: torch.Tensor  # (n_rows+1,) int32
    t_ptr: torch.Tensor    # (n_cols+1,) int32: row pointer of Xᵀ
    t_rows: torch.Tensor   # (nnz,) int32: Xᵀ's column ids (rows of X), per row ascending
    t_perm: torch.Tensor   # (nnz,) int64: values[t_perm] are Xᵀ's values in its order
    t_work: WorkList       # kernel 3's work list over the rows of Xᵀ
    work: WorkList         # kernel 2's work list over the rows of X

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                 n_cols: int, device: str | torch.device,
                 dtype: torch.dtype = torch.float32) -> "SparseFeatures":
        """The feature CSR on ``device``, its values in ``dtype`` (rounded to
        nearest even for bf16)."""
        device = torch.device(device)
        indptr = np.asarray(indptr, np.int64)
        cols = np.asarray(indices, np.int64)
        n_rows = len(indptr) - 1
        if len(cols) and not 0 <= cols.min() <= cols.max() < n_cols:
            raise ValueError(f"feature ids must lie in [0, {n_cols})")
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        t_perm = np.argsort(cols, kind="stable")  # by column, rows ascending within one
        t_ptr = np.zeros(n_cols + 1, np.int64)
        np.cumsum(np.bincount(cols, minlength=n_cols), out=t_ptr[1:])

        def dev(a, dtype=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        return cls(values=dev(np.asarray(values, np.float32), torch.float32).to(dtype),
                   rows=dev(rows),
                   cols=dev(cols), n_rows=n_rows, n_cols=n_cols, row_ptr=dev(indptr),
                   t_ptr=dev(t_ptr), t_rows=dev(rows[t_perm]), t_perm=dev(t_perm, torch.int64),
                   t_work=csr_work_list(t_ptr, device), work=csr_work_list(indptr, device))


def slice_feature_rows(indptr, indices, values, lo: int, hi: int, block: int):
    """One part's feature-CSR rows [lo, hi), re-based to row 0 and padded to
    ``block`` rows of no nnz (cuda_gcn_tpu/ops/matmul.py:200-211): (indptr,
    indices, values)."""
    sub_ptr = indptr[lo:hi + 1].astype(np.int64) - np.int64(indptr[lo])
    if block > hi - lo:
        sub_ptr = np.concatenate([sub_ptr, np.full(block - (hi - lo), sub_ptr[-1], np.int64)])
    sl = slice(int(indptr[lo]), int(indptr[hi]))
    return sub_ptr, indices[sl], values[sl]


def make_sparse_features_parts(indptr, indices, values, bounds, block: int, n_cols: int,
                               dtype: torch.dtype, device) -> list[SparseFeatures]:
    """One ``SparseFeatures`` of ``block`` rows per part of ``bounds`` (the
    P+1 part boundaries) on ``device``, values in ``dtype``."""
    bounds = np.asarray(bounds, dtype=np.int64)
    return [SparseFeatures.from_csr(
        *slice_feature_rows(indptr, indices, values, int(bounds[p]), int(bounds[p + 1]),
                            block), n_cols, device, dtype) for p in range(len(bounds) - 1)]


def csr_matmul_plain(values, rows, cols, w, n_rows: int) -> torch.Tensor:
    """Plain version (the JAX package's signature): values cast to W's type,
    index, scale and ``index_add_`` in f32, one cast to W's type;
    differentiable in ``values`` and ``w``."""
    gathered = w[cols.long()].float() * values.to(w.dtype).float()[:, None]
    return torch.zeros(n_rows, w.shape[1], dtype=torch.float32, device=w.device).index_add_(
        0, rows.long(), gathered).to(w.dtype)


def csr_matmul_dw(x: SparseFeatures, values, g) -> torch.Tensor:
    """dW = Xᵀ·g, [F, d] in g's type, with ``values`` in X's order and of g's
    type: kernel 3 over the work list of Xᵀ on the card."""
    t_values = values.detach()[x.t_perm]
    if g.device.type == "cpu":
        return csr_matmul_plain(t_values, x.cols[x.t_perm], x.t_rows, g, x.n_cols)
    t = x.t_work
    return kernels.ell_spmm(t.beg, t.len, t.dst, t.split_rows, t.split_ptr, x.t_rows,
                            t_values, g, x.n_cols, t.n_partials)


class _CsrMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, w, x: SparseFeatures):
        ctx.x = x
        ctx.save_for_backward(values, w)
        return kernels.csr_spmm(x.work, x.cols, values.detach().to(w.dtype), w.detach(),
                                x.n_rows)

    @staticmethod
    def backward(ctx, g):
        values, w = ctx.saved_tensors
        x = ctx.x
        g = g.contiguous()
        d_values = d_w = None
        if ctx.needs_input_grad[0]:
            d_values = (w[x.cols.long()] * g[x.rows.long()]).sum(1).to(values.dtype)
        if ctx.needs_input_grad[1]:
            d_w = csr_matmul_dw(x, values.to(w.dtype), g)
        return d_values, d_w, None


def csr_matmul(values: torch.Tensor, x: SparseFeatures, w: torch.Tensor) -> torch.Tensor:
    """X·W for X = (``values`` at ``x``'s positions), [n_rows, d] in W's type.
    ``values`` may differ from ``x.values`` (dropout); the pattern is ``x``'s."""
    if w.device.type == "cpu":
        return csr_matmul_plain(values, x.rows, x.cols, w, x.n_rows)
    return _CsrMatmul.apply(values, w, x)
