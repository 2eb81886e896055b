"""GCNII's convolution epilogue (Chen et al., arXiv:2007.02133, eq. 5): what
follows convolution l's blended pass s = (1 − α)·Â·h + α·h0 (ops/blend.py) in
the fused epoch's pair, up to the next layer's dropped input:

    z_t = θ·(s_t·W) + (1 − θ)·s_t,   h_t = keep ? ReLU(z_t) / (1 − p) : 0
    z_e = θ·(s_e·W) + (1 − θ)·s_e,   h_e = ReLU(z_e)

keep being the next layer's dropout mask. On the card it is one launch of
``kernels.gcnii_epilogue`` (csrc/gcnii_epilogue.cu), which draws the mask
itself (Philox under two int64 seeds drawn on the device from the job's
generator, for each launch: ``gcnii_keep`` restates it) and writes both halves
straight into the [N, 2H] input of the next blended pass (``concat``), or
apart for the output layer; its backward is one launch of
``kernels.gcnii_epilogue_bwd`` (gz = [z_t > 0]·(keep ? g / (1 − p) : 0), gs =
θ·gz·Wᵀ + (1 − θ)·gz) and dW = θ·s_tᵀ·gz a cuBLAS product. The training half
saves s_t, the mask (bool [N, H]: the layer's mask, as dropout's ``where``
saved it) and ReLU's sign as bits (int32 [N, H/32]), nothing else of [N, H].

A tensor on the CPU takes the plain versions (``epilogue_plain``,
``epilogue_bwd_plain``: the kernel's operations in torch, with its mask and
constants, the product summed in f64 and rounded once), of any floating
type, so that the gradient can be checked in f64. GCNII takes the epilogue on
the card where ``fuses`` (models/gcnii.py), and ATen's chain elsewhere.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.ops.matmul import philox_keep


def fuses(s: torch.Tensor) -> bool:
    """Whether the epilogue's kernels take the blended pass ``s``: f32 on a
    card, at a width they are built for."""
    return s.is_cuda and s.dtype == torch.float32 and s.dim() == 2 \
        and s.shape[1] in kernels.GCNII_EPILOGUE_WIDTHS


def gcnii_keep(seeds, n: int, h: int, rate: float, device=None) -> torch.Tensor:
    """The epilogue's mask, [n, h] bool on ``device``: element (r, c) takes
    word c % 4 of the Philox call at counter (r·⌈h/4⌉ + c/4 as two words, then
    the offset seeds[1] as two) under the key seeds[0], and is kept where the
    word lies below ``kernels.gcnii_dropout(rate)``'s threshold."""
    return philox_keep(seeds, torch.arange(n, device=device), h,
                       kernels.gcnii_dropout(rate)[1])


def pack_bits(pos: torch.Tensor) -> torch.Tensor:
    """[n, h] bool -> [n, ⌈h/32⌉] int32: bit c % 32 of word c / 32 is column c."""
    n, h = pos.shape
    words = -(-h // 32)
    pos = torch.nn.functional.pad(pos, (0, 32 * words - h)).view(n, words, 32)
    weights = torch.tensor([1 << j for j in range(32)], dtype=torch.int64, device=pos.device)
    sums = (pos.to(torch.int64) * weights).sum(-1)
    return (sums - (sums >= 2**31).to(torch.int64) * 2**32).to(torch.int32)


def unpack_bits(relu: torch.Tensor, h: int) -> torch.Tensor:
    """``pack_bits``' inverse: [n, ⌈h/32⌉] int32 -> [n, h] bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=relu.device)
    return ((relu.unsqueeze(-1) >> shifts) & 1).bool().reshape(relu.shape[0], -1)[:, :h]


def _constants(theta: float, rate: float) -> tuple[float, float, float]:
    """θ and 1 − θ in f32, as the kernels take them, and the kept values'
    factor ``kernels.gcnii_dropout(rate)``."""
    return float(np.float32(theta)), float(np.float32(1.0 - theta)), \
        kernels.gcnii_dropout(rate)[0]


def _identity_map(s, w, theta, omt):
    """θ·(s·W) + (1 − θ)·s, the product summed in f64 and rounded once to s's
    type, then each term rounded, then their sum."""
    return (s.double() @ w.double()).to(s.dtype) * theta + s * omt


def epilogue_plain(st, se, w, seeds, theta: float, rate: float, concat: bool):
    """Plain version of ``kernels.gcnii_epilogue``, on st's device and type:
    (ht, he, keep, relu), ht and he views of one [n, 2H] tensor where
    ``concat``."""
    theta, omt, scale = _constants(theta, rate)
    n, h = st.shape
    zt, ze = _identity_map(st, w, theta, omt), _identity_map(se, w, theta, omt)
    pos = ~(zt <= 0)  # ReLU as threshold: NaN passes
    keep = gcnii_keep(seeds.tolist(), n, h, rate, st.device)
    zero = torch.zeros((), dtype=st.dtype, device=st.device)
    ht = torch.where(keep & pos, zt * scale, zero)
    he = torch.where(ze <= 0, zero, ze)
    if concat:
        both = torch.cat([ht, he], dim=1)
        ht, he = both[:, :h], both[:, h:]
    return ht, he, keep, pack_bits(pos)


def epilogue_bwd_plain(g, keep, relu, w, theta: float, rate: float):
    """Plain version of ``kernels.gcnii_epilogue_bwd``: (gs, gz) in g's type."""
    theta, omt, scale = _constants(theta, rate)
    pos = unpack_bits(relu, g.shape[1])
    gz = torch.where(keep & pos, g * scale, torch.zeros((), dtype=g.dtype, device=g.device))
    return (gz.double() @ w.double().t()).to(g.dtype) * theta + gz * omt, gz


def _forward(st, se, w, seeds, theta: float, rate: float, concat: bool):
    """The forward's launch, or its plain version for a CPU tensor."""
    if st.device.type == "cpu":
        return epilogue_plain(st, se, w, seeds, theta, rate, concat)
    return kernels.gcnii_epilogue(st, se, w, seeds, theta, rate, concat)


def _backward(g, keep, relu, w, theta: float, rate: float):
    """The backward's launch, or its plain version for a CPU tensor."""
    if g.device.type == "cpu":
        return epilogue_bwd_plain(g, keep, relu, w, theta, rate)
    return kernels.gcnii_epilogue_bwd(g, keep, relu, w, theta, rate)


class _Epilogue(torch.autograd.Function):
    """The epilogue, differentiated in s_t and W: it saves s_t, the mask and
    ReLU's bits."""

    @staticmethod
    def forward(ctx, st, w, se, seeds, theta, rate, concat):
        ht, he, keep, relu = _forward(st, se, w, seeds, theta, rate, concat)
        ctx.save_for_backward(st, w, keep, relu)
        ctx.theta, ctx.rate = theta, rate
        ctx.mark_non_differentiable(he)
        ctx.set_materialize_grads(False)  # he has none: no [N, H] of zeros for it
        return ht, he

    @staticmethod
    def backward(ctx, g, _):
        if g is None:
            return (None,) * 7
        st, w, keep, relu = ctx.saved_tensors
        gs, gz = _backward(g.contiguous(), keep, relu, w, ctx.theta, ctx.rate)
        dw = st.t().mm(gz).mul_(_constants(ctx.theta, 0.0)[0]) if ctx.needs_input_grad[1] \
            else None
        return gs, dw, None, None, None, None, None


def gcnii_epilogue(st: torch.Tensor, se: torch.Tensor, w: torch.Tensor, theta: float,
                   rate: float, generator: torch.Generator | None, concat: bool):
    """(h_t, h_e) of convolution W's blended passes st, se [N, H] (above): the
    next layer's dropped training input and its evaluation input, side by side
    in one [N, 2H] tensor where ``concat``; only h_t has a gradient (in st and
    W). The mask's two seeds are drawn on st's device from ``generator``: a
    CUDA graph that registers it draws anew at each replay."""
    seeds = torch.empty(2, dtype=torch.int64, device=st.device).random_(generator=generator)
    return _Epilogue.apply(st, w, se.detach(), seeds, theta, rate, concat)
