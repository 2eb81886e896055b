"""Build, load and launch the hand-written CUDA kernels.

At first use each source in ``cuda_gcn_torch/csrc/*.cu`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface under
``build/kernels/`` at the repository root (one ``nvcc`` per source, started
together), and loaded with ctypes. A library's file name carries a hash of its
source, of the headers of ``csrc/`` that the source includes, and of the flags,
so an edited source or header is rebuilt. Nothing is built or loaded
when this module is imported.

Each launcher checks device, dtype, shape and contiguity, allocates its
output, launches on PyTorch's current stream (read at every call) without
synchronising, raises if the C entry point returns a CUDA error, and adds one
to its entry in ``launches`` — in ``_call`` and nowhere else. There is no
fallback: a failed build or launch raises.

A launch of a small kernel is bound by this path, so it does once what can be
done once: each C function is bound with its argtypes when its library is
loaded, devices are compared by index, and a refusal is worded only when
there is one.

The GAT's attention kernels (``gat_forward``, ``gat_rows``, ``gat_cols``,
csrc/gat_attention.cu), kernel 3's blended form (``ell_blend``, GCNII's
initial residual) and GCNII's convolution epilogue (``gcnii_epilogue``,
``gcnii_epilogue_bwd``, csrc/gcnii_epilogue.cu) take f32 alone. Kernels 1-3
and the dense layer-0 kernel (``layer0_pair``) take f32 or bf16
activations (``ACT_DTYPES``): each C entry gets a dtype code (``dtype_code``,
``spmm_code``) and runs the variant built for it, with f32 sums and the
output in h's type. A type that has no variant is refused here, and by the C
entry; nothing is cast to reach another variant.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# Source, C entry point and argtypes of each kernel; every entry returns
# cudaError_t.
_ENTRY = {
    "bsr_tile": ("bsr_tile", "bsr_tile_contract",
                 [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "csr_spmm": ("csr_spmm", "csr_spmm",
                 [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "ell_spmm": ("ell_spmm", "ell_spmm",
                 [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "gather_probe": ("gather_probe", "gather_probe",
                     [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P]),
    "scatter_probe": ("gather_probe", "scatter_probe", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "taa_rows": ("taa_probe", "taa_rows",
                 [_P, _L, _L, _L, _P, _I, _P, _I, _I, _I, _I, _I, _P]),
    "taa_lanes": ("taa_probe", "taa_lanes",
                  [_P, _L, _L, _L, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "cumsum_cols": ("taa_probe", "cumsum_cols", [_P, _P, _P, _I, _I, _I, _P]),
    "piece": ("taa_probe", "piece", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "layer0_pair": ("layer0_pair", "layer0_pair",
                    [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, ctypes.c_float,
                     ctypes.c_float, _I, ctypes.c_uint32, _I, _I, _I, _P]),
    "gat_forward": ("gat_attention", "gat_forward",
                    [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                     _P]),
    "gat_rows": ("gat_attention", "gat_rows",
                 [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                  _P]),
    "gat_cols": ("gat_attention", "gat_cols",
                 [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                  _I, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                  _P]),
    "ell_blend": ("ell_spmm", "ell_blend",
                  [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                   ctypes.c_float, ctypes.c_float, _P]),
    "gcnii_epilogue": ("gcnii_epilogue", "gcnii_epilogue",
                       [_P, _P, _P, _P, _P, _P, _L, _P, _P, _L, _I, ctypes.c_float,
                        ctypes.c_float, ctypes.c_float, _L, _P]),
    "gcnii_epilogue_bwd": ("gcnii_epilogue", "gcnii_epilogue_bwd",
                           [_P, _P, _P, _P, _P, _P, _L, _I, ctypes.c_float, ctypes.c_float,
                            ctypes.c_float, _P]),
}
SOURCES = sorted({src for src, _, _ in _ENTRY.values()})

launches = {name: 0 for name in _ENTRY}
# The lane split each attention launch took: (launcher, VEC, L2, STEPS) -> launches
gat_layouts: dict[tuple[str, int, int, int], int] = {}
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict = {}  # kernel name -> its bound C function, once its library is loaded


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    gat_layouts.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit under /usr/local/cuda)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_files(name: str) -> list[str]:
    """``name``.cu and every file of ``SRC_DIR`` that it includes, directly or
    through another one, in the order found."""
    files, queue = [], [f"{name}.cu"]
    while queue:
        rel = queue.pop(0)
        path = os.path.join(SRC_DIR, rel)
        if rel in files or not os.path.exists(path):
            continue
        files.append(rel)
        with open(path, "rb") as f:
            queue += [m.decode() for m in _INCLUDE.findall(f.read())]
    return files


def _lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in _source_files(name):
        with open(os.path.join(SRC_DIR, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:12]}.so")


def build(names=None) -> dict[str, dict]:
    """Compile the named sources (all of ``SOURCES`` by default) that have no
    up-to-date library, in parallel. Returns {name: {"seconds", "log"}} for the
    sources compiled; raises with nvcc's output if one fails."""
    names = SOURCES if names is None else list(names)
    todo = {n: _lib_path(n) for n in names if not os.path.exists(_lib_path(n))}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        cmd = [nvcc, *NVCC_FLAGS, "-o", path + ".tmp",
               os.path.join(SRC_DIR, f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    report, failed = {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
        else:
            os.replace(todo[name] + ".tmp", todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def _lib(source: str) -> ctypes.CDLL:
    """Build (if need be) and load ``source``'s library, and bind the C function
    of every kernel it holds."""
    lib = _libs.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(_lib_path(source))
        for name, (src, fn_name, argtypes) in _ENTRY.items():
            if src == source:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
        _libs[source] = lib
    return lib


def _call(name: str, *args) -> None:
    fn = _fns.get(name)
    if fn is None:
        _lib(_ENTRY[name][0])
        fn = _fns[name]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    launches[name] += 1


def _on_cuda(t: torch.Tensor, name: str) -> int:
    """The index of the CUDA device that ``t``, the launch's main operand, lies
    on; a tensor that is not on a card is refused."""
    if not t.is_cuda:
        raise RuntimeError(f"{name} launches on a CUDA tensor, got {t.device}")
    return t.get_device()


def _check(t: torch.Tensor, what: str, dtype, index: int) -> None:
    """Refuse a tensor that is not contiguous, of ``dtype`` and on CUDA device
    ``index``."""
    if t.dtype is dtype and t.is_cuda and t.get_device() == index and t.is_contiguous():
        return
    if not t.is_cuda or t.get_device() != index:
        raise ValueError(f"{what} is on {t.device}, expected cuda:{index}")
    if t.dtype is not dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    raise ValueError(f"{what} must be contiguous")


# torch's own getter of the current stream's handle, without the Stream object
# that torch.cuda.current_stream builds (CUDA builds of torch only)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


# The activation types of kernels 1-3, by the code their C entries take.
ACT_DTYPES = (torch.float32, torch.bfloat16)


def dtype_code(dtype) -> int:
    """0 for f32, 1 for bf16: the code of an activation (or coefficient) type."""
    return ACT_DTYPES.index(dtype)


# Kernels 2 and 3 are built for these (h, coef) pairs, by code 2 * h + coef: f32
# rows with f32 or bf16 coefficients (an f32 layer on a graph built for bf16
# activations: sparse features at f32 weights) and bf16 rows with bf16 ones.
SPMM_VARIANTS = {(torch.float32, torch.float32): 0, (torch.float32, torch.bfloat16): 1,
                 (torch.bfloat16, torch.bfloat16): 3}


def spmm_code(h_dtype, coef_dtype) -> int:
    """The code of kernels 2 and 3 for rows of ``h_dtype`` and coefficients of
    ``coef_dtype``; a pair without a variant is refused."""
    code = SPMM_VARIANTS.get((h_dtype, coef_dtype))
    if code is None:
        raise TypeError(f"kernels 2 and 3 have no variant for h of {h_dtype} with coef of "
                        f"{coef_dtype} (built: {sorted(SPMM_VARIANTS.values())}); a graph "
                        f"for bf16 activations is built with act_itemsize=2")
    return code


# Kernel 1 (csrc/bsr_tile.cu). The tensor-core kernel takes bf16 tiles whose
# size is a multiple of 64 up to 256, at most 88 features wide; its
# accumulators are BSR_MMA_WIDTHS wide, and it reads h as BSR_PLANES bf16
# planes: the three bf16 parts of f32 h, or bf16 h itself. The FMA kernel's CTA
# covers a block row of at most 256 rows (2 per thread), walking the tile in
# 32-column steps.
BSR_MAX_TB = 256
BSR_TB_MULTIPLE = 32
BSR_MMA_TB_MULTIPLE = 64
BSR_MMA_WIDTHS = (16, 32, 48, 88)
BSR_PLANES = {torch.float32: 3, torch.bfloat16: 1}


def bsr_mma_width(tiles_dtype, tb: int, k: int, d: int,
                  h_dtype=torch.float32) -> int | None:
    """The accumulator width of the tensor-core kernel for this call, or None
    where the FMA kernel takes it: f32 tiles (for bf16 h too: the kernel rounds
    them to bf16 as it reads them), a tile size that is no multiple of 64, more
    than 88 features, or no tile at all. ``h_dtype`` is f32 or bf16."""
    if h_dtype not in BSR_PLANES:
        raise TypeError(f"kernel 1 takes f32 or bf16 h, got {h_dtype}")
    if tiles_dtype != torch.bfloat16 or tb % BSR_MMA_TB_MULTIPLE or k == 0 \
            or d > BSR_MMA_WIDTHS[-1]:
        return None
    return next(w for w in BSR_MMA_WIDTHS if d <= w)


def bsr_tile(tiles, ptr, order, hblk, h, n: int, t_blocks: int, transpose: bool,
             row_order=None) -> torch.Tensor:
    """Launch kernel 1: returns the dense-tile part [n, d] in h's type (f32 or
    bf16), summed in f32.

    Which of the source's two kernels runs is decided here, by what
    ``bsr_mma_width`` reads (tile dtype, tile size, width), never by a failed
    build or launch: bf16 tiles go to the tensor-core kernel (f32 h as its
    three bf16 parts, bf16 h as it is; f32 accumulators; one launch counts its
    pre-pass and the contraction as one), everything else to the FMA kernel.
    ``row_order`` (``TilePlan.by_load``, optional) is the order in which CTAs
    take the block rows."""
    dev = _on_cuda(h, "bsr_tile")
    h = h.contiguous()
    if h.dtype not in ACT_DTYPES:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    _check(h, "h", h.dtype, dev)
    if tiles.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"tiles must be bfloat16 or float32, got {tiles.dtype}")
    _check(tiles, "tiles", tiles.dtype, dev)
    _check(ptr, "ptr", torch.int32, dev)
    _check(order, "order", torch.int32, dev)
    _check(hblk, "hblk", torch.int32, dev)
    if tiles.dim() != 3 or tiles.shape[2] != tiles.shape[1]:
        raise ValueError(f"tiles must be [K, tb, tb], got {tuple(tiles.shape)}")
    k, tb = tiles.shape[0], tiles.shape[1]
    d = h.shape[1]
    if tb > BSR_MAX_TB or tb % BSR_TB_MULTIPLE:
        raise ValueError(f"tile size {tb} must be a multiple of "
                         f"{BSR_TB_MULTIPLE} and at most {BSR_MAX_TB}")
    tiles_ptr = tiles.data_ptr()
    if tiles_ptr % 16:
        raise ValueError("tiles must be 16-byte aligned (the kernel loads 16 bytes at a time)")
    if h.shape[0] != n or ptr.numel() != t_blocks + 1 or order.numel() != k \
            or hblk.numel() != k or t_blocks * tb < n or t_blocks > 65535:
        raise ValueError("bsr_tile: inconsistent shapes")
    if row_order is not None:
        _check(row_order, "row_order", torch.int32, dev)
        if row_order.numel() != t_blocks:
            raise ValueError(f"row_order must hold {t_blocks} block rows")
    out = torch.empty(n, d, dtype=h.dtype, device=h.device)
    if n == 0 or d == 0:
        return out
    width = bsr_mma_width(tiles.dtype, tb, k, d, h.dtype)
    planes = None if width is None else torch.empty(
        BSR_PLANES[h.dtype] * width * t_blocks * tb, dtype=torch.bfloat16, device=h.device)
    _call("bsr_tile", ptr.data_ptr(), order.data_ptr(), hblk.data_ptr(),
          None if row_order is None else row_order.data_ptr(), tiles_ptr,
          int(tiles.dtype is torch.bfloat16), h.data_ptr(),
          None if planes is None else planes.data_ptr(), out.data_ptr(), n, d, tb,
          t_blocks, k, int(transpose), dtype_code(h.dtype), _stream(dev))
    return out


def spmm_vec(d: int, *bases: int, itemsize: int = 4) -> int:
    """How many features a lane of kernels 2 and 3 loads and stores at once
    (csrc/spmm_common.cuh), reasoned in bytes: the widest load of 16, 8 or 4
    bytes whose features (``itemsize`` bytes each: 4 of f32, 8 of bf16 in 16
    bytes) divide the width ``d`` and whose size aligns the first two bases (h
    and out, rows d features apart); the further bases are the f32 partial
    sums, aligned to the f32 store of the same features (16 bytes at most).
    Else one feature: 4 bytes of f32, 2 of bf16. So a bf16 row at d = 16 or 32
    takes 16-byte loads, at d = 82 (164 bytes) 4-byte ones and at d = 41 (82
    bytes) 2-byte ones."""
    for nbytes in (16, 8, 4):
        vec = nbytes // itemsize
        if vec > 1 and d % vec == 0 and not any(b % nbytes for b in bases[:2]) \
                and not any(b % min(4 * vec, 16) for b in bases[2:]):
            return vec
    return 1


def csr_spmm(work, cols, coef, h, n: int, out=None) -> torch.Tensor:
    """Launch kernel 2 over the work list ``work`` of a CSR's rows (ops/ell.py
    ``WorkList``): Σ_e coef·h[col] per row, summed in f32, added in place to
    ``out`` when given (read, added in f32, stored once), else written to a new
    [n, d] tensor, in h's type. ``h`` and ``coef`` are a pair of
    ``SPMM_VARIANTS``. ``n`` is the number of CSR rows; ``cols`` index the rows
    of h, of which there may be any number (n for an adjacency, F for a feature
    matrix times [F, d]). When adding to ``out`` only the items that have edges
    are launched."""
    dev = _on_cuda(h, "csr_spmm")
    h = h.contiguous()
    code = spmm_code(h.dtype, coef.dtype)
    _check(h, "h", h.dtype, dev)
    _check(work.beg, "work.beg", torch.int32, dev)
    _check(work.len, "work.len", torch.int32, dev)
    _check(work.dst, "work.dst", torch.int32, dev)
    _check(work.split_rows, "work.split_rows", torch.int32, dev)
    _check(work.split_ptr, "work.split_ptr", torch.int32, dev)
    _check(cols, "cols", torch.int32, dev)
    _check(coef, "coef", coef.dtype, dev)
    n_items, n_split = work.beg.numel(), work.split_rows.numel()
    if n < 0 or h.dim() != 2 or cols.numel() != coef.numel() \
            or work.len.numel() != n_items or work.dst.numel() != n_items \
            or work.split_ptr.numel() != n_split + 1 or not 0 <= work.n_nonempty <= n_items:
        raise ValueError("csr_spmm: inconsistent shapes")
    d = h.shape[1]
    accumulate = out is not None
    if out is None:
        out = torch.empty(n, d, dtype=h.dtype, device=h.device)
    else:
        _check(out, "out", h.dtype, dev)
        if out.dim() != 2 or out.shape[0] != n or out.shape[1] != d:
            raise ValueError(f"out must be [{n}, {d}], got {tuple(out.shape)}")
    if n == 0 or d == 0:
        return out
    partial = torch.empty(work.n_partials, d, dtype=torch.float32, device=h.device)
    h_ptr, out_ptr, partial_ptr = h.data_ptr(), out.data_ptr(), partial.data_ptr()
    _call("csr_spmm", work.beg.data_ptr(), work.len.data_ptr(), work.dst.data_ptr(),
          work.n_nonempty if accumulate else n_items, work.split_rows.data_ptr(),
          work.split_ptr.data_ptr(), n_split, cols.data_ptr(), coef.data_ptr(),
          h_ptr, out_ptr, partial_ptr, d,
          spmm_vec(d, h_ptr, out_ptr, partial_ptr, itemsize=h.element_size()),
          int(accumulate), code, _stream(dev))
    return out


def _check_ell(dev: int, work_beg, work_len, work_dst, split_rows, split_ptr, cols, coef,
               coef_dtype) -> None:
    """Kernel 3's work list and slots: int32, and coefficients of ``coef_dtype``,
    each contiguous on CUDA device ``dev``."""
    for t, what in ((work_beg, "work_beg"), (work_len, "work_len"), (work_dst, "work_dst"),
                    (split_rows, "split_rows"), (split_ptr, "split_ptr"), (cols, "cols")):
        _check(t, what, torch.int32, dev)
    _check(coef, "coef", coef_dtype, dev)


def ell_spmm(work_beg, work_len, work_dst, split_rows, split_ptr, cols, coef, h,
             n: int, n_partials: int) -> torch.Tensor:
    """Launch kernel 3 over a work list (ops/ell.py ``WorkList``): returns the
    [n, d] product, summed in f32, as a new tensor of h's type. ``h`` and
    ``coef`` are a pair of ``SPMM_VARIANTS``. ``n`` is the number of output
    rows; ``cols`` index the rows of h, of which there may be any number."""
    dev = _on_cuda(h, "ell_spmm")
    h = h.contiguous()
    code = spmm_code(h.dtype, coef.dtype)
    _check(h, "h", h.dtype, dev)
    _check_ell(dev, work_beg, work_len, work_dst, split_rows, split_ptr, cols, coef, coef.dtype)
    n_items, n_split = work_beg.numel(), split_rows.numel()
    if h.dim() != 2 or work_len.numel() != n_items or work_dst.numel() != n_items \
            or split_ptr.numel() != n_split + 1 or cols.numel() != coef.numel():
        raise ValueError("ell_spmm: inconsistent shapes")
    d = h.shape[1]
    out = torch.empty(n, d, dtype=h.dtype, device=h.device)
    if n == 0 or d == 0:
        return out
    partial = torch.empty(n_partials, d, dtype=torch.float32, device=h.device)
    h_ptr, out_ptr, partial_ptr = h.data_ptr(), out.data_ptr(), partial.data_ptr()
    _call("ell_spmm", work_beg.data_ptr(), work_len.data_ptr(), work_dst.data_ptr(),
          n_items, split_rows.data_ptr(), split_ptr.data_ptr(), n_split, cols.data_ptr(),
          coef.data_ptr(), h_ptr, out_ptr, partial_ptr, d,
          spmm_vec(d, h_ptr, out_ptr, partial_ptr, itemsize=h.element_size()), code,
          _stream(dev))
    return out


def ell_blend(work_beg, work_len, work_dst, split_rows, split_ptr, cols, coef, h, h0,
              n: int, n_partials: int, a: float, b: float, halves: int = 1):
    """Launch kernel 3's blended form (f32 rows and coefficients) over a work
    list: out = a·(the product) + b·h0, each row written once. ``halves`` 1:
    h [*, d], h0 [n, d] or None (out = a·the product), returns out [n, d].
    ``halves`` 2 (the fused pair): h [*, 2·dh] the two halves side by side, h0
    a pair of [n, dh] tensors or None, returns the pair (out_lo, out_hi) of
    [n, dh] tensors, each half in a tensor of its own."""
    dev = _on_cuda(h, "ell_blend")
    h = h.contiguous()
    f32 = torch.float32
    _check(h, "h", f32, dev)
    _check_ell(dev, work_beg, work_len, work_dst, split_rows, split_ptr, cols, coef, f32)
    h0s = () if h0 is None else ((h0,) if halves == 1 else tuple(h0))
    for i, t in enumerate(h0s):
        _check(t, f"h0[{i}]", f32, dev)
    n_items, n_split = work_beg.numel(), split_rows.numel()
    d = h.shape[1] if h.dim() == 2 else -1
    dh = d // halves if halves in (1, 2) else -1
    if dh < 0 or d % halves or work_len.numel() != n_items or work_dst.numel() != n_items \
            or split_ptr.numel() != n_split + 1 or cols.numel() != coef.numel() \
            or (h0 is not None and len(h0s) != halves) \
            or any(tuple(t.shape) != (n, dh) for t in h0s):
        raise ValueError("ell_blend: inconsistent shapes")
    outs = tuple(torch.empty(n, dh, dtype=f32, device=h.device) for _ in range(halves))
    if n == 0 or d == 0:
        return outs[0] if halves == 1 else outs
    partial = torch.empty(n_partials, d, dtype=f32, device=h.device)
    ptrs = (h.data_ptr(), outs[0].data_ptr(), partial.data_ptr())
    # the load width of kernel 3's rule at d, narrowed to one that the halves'
    # width and bases take too
    halves_ptrs = (outs[-1].data_ptr(), *(t.data_ptr() for t in h0s))
    vec = math.gcd(spmm_vec(d, *ptrs), spmm_vec(dh, *halves_ptrs))
    _call("ell_blend", work_beg.data_ptr(), work_len.data_ptr(), work_dst.data_ptr(), n_items,
          split_rows.data_ptr(), split_ptr.data_ptr(), n_split, cols.data_ptr(), coef.data_ptr(),
          *ptrs, d, vec, h0s[0].data_ptr() if h0s else None,
          h0s[-1].data_ptr() if h0s else None, outs[-1].data_ptr(), dh, float(a), float(b),
          _stream(dev))
    return outs[0] if halves == 1 else outs


# Shared memory a block can opt into on the H100, and its number of SMs.
SMEM_BLOCK_BYTES = 232448
H100_SMS = 132
# Probe A (csrc/gather_probe.cu) counts the ids, then contracts the counts with
# the table: its paths by their number in the C interface. A count CTA takes at
# least GATHER_MIN_COUNT_IDS ids and there are at most GATHER_MAX_COUNT_BLOCKS;
# the contraction's CTAs, at most GATHER_CONTRACT_CTAS, take chunks of
# GATHER_CONTRACT_ROWS table rows in turn and write one partial row each.
GATHER_PATHS = ("shared", "global")
GATHER_MIN_COUNT_IDS = 8192
GATHER_MAX_COUNT_BLOCKS = 2 * H100_SMS
GATHER_CONTRACT_ROWS = 128
GATHER_CONTRACT_CTAS = 128


def gather_probe_path(rows: int) -> str:
    """Where probe A counts: 'shared', a histogram a CTA in shared memory, for a
    table whose int32 counts fit a block's shared memory (at most 58,112 rows);
    'global', one count array in device memory, for a larger one."""
    return "shared" if 4 * rows <= SMEM_BLOCK_BYTES else "global"


def gather_count_blocks(m: int, rows: int, path: str) -> int:
    """How many CTAs count the ``m`` ids: at least GATHER_MIN_COUNT_IDS ids
    each, at most GATHER_MAX_COUNT_BLOCKS; on the shared path also no more than
    m / rows, so that the CTAs' histograms hold no more ints than idx."""
    blocks = min(GATHER_MAX_COUNT_BLOCKS, -(-m // GATHER_MIN_COUNT_IDS))
    if path == "shared":
        blocks = min(blocks, m // rows)
    return max(1, blocks)


def gather_probe(idx, h) -> torch.Tensor:
    """Launch probe A: Σ_i h[idx[i]] as a [1, d] tensor in f32, computed as
    Σ_r count[r]·h[r] (``gather_probe_path`` names where it counts). An id
    outside [0, rows) is not counted and makes every element of the result
    NaN, and no memory outside the scratch is written (the plain version
    indexes as torch does: it raises for an id >= rows)."""
    dev = _on_cuda(h, "gather_probe")
    _check(idx, "idx", torch.int32, dev)
    _check(h, "h", torch.float32, dev)
    if h.dim() != 2:
        raise ValueError(f"h must be [rows, d], got {tuple(h.shape)}")
    m, (rows, d) = idx.numel(), h.shape
    if m >= 2**31:
        raise ValueError(f"gather_probe counts fewer than 2^31 ids, got {m}")
    if m == 0 or d == 0:
        return torch.zeros(1, d, dtype=torch.float32, device=h.device)
    path = gather_probe_path(rows)
    blocks = gather_count_blocks(m, rows, path)
    # the count arrays, the ticket that elects the CTA adding the partial rows
    # (the count kernel clears it), and a stray-id flag a count CTA (each writes
    # its own)
    if path == "shared":
        counts = torch.empty(blocks * rows + 1 + blocks, dtype=torch.int32, device=h.device)
    else:
        counts = torch.zeros(rows + 1 + blocks, dtype=torch.int32, device=h.device)
    partial = torch.empty(min(-(-rows // GATHER_CONTRACT_ROWS), GATHER_CONTRACT_CTAS), d,
                          dtype=torch.float32, device=h.device)
    out = torch.empty(1, d, dtype=torch.float32, device=h.device)
    _call("gather_probe", idx.data_ptr(), h.data_ptr(), counts.data_ptr(), partial.data_ptr(),
          out.data_ptr(), m, rows, d, blocks, GATHER_PATHS.index(path), _stream(dev))
    return out


# Probe B (csrc/gather_probe.cu) is one cooperative launch of SCATTER_CTAS
# CTAs, 2 an SM, all resident, over tiles of at most SCATTER_TILE_IDS ids
# (``probes.gather.scatter_split_plain`` restates how they share the work).
SCATTER_CTAS = 2 * H100_SMS
SCATTER_TILE_IDS = 2048


def scatter_probe(idx, coef, h, mb: int) -> torch.Tensor:
    """Launch probe B: out[idx[i]] += coef[i] · h[i mod rows] for i < mb into
    a new [rows, d] tensor in f32, each row's terms added in index order from
    0, the product and the sum rounded apart (the TPU loop's bits).

    ``idx[:mb]`` must be sorted ascending, with ids in [0, rows): the kernel
    checks both and, if either fails, writes NaN to every element of out (the
    plain version sums ids in any order and raises for one outside the
    table). Its scratch, an int32 fault flag for each of SCATTER_CTAS, lies
    past the end of out in one allocation (a call's host time exceeds its
    device time, and an allocation is a good part of it)."""
    dev = _on_cuda(h, "scatter_probe")
    _check(idx, "idx", torch.int32, dev)
    _check(coef, "coef", torch.float32, dev)
    _check(h, "h", torch.float32, dev)
    if h.dim() != 2:
        raise ValueError(f"h must be [rows, d], got {tuple(h.shape)}")
    rows, d = h.shape
    if not 0 <= mb <= min(idx.numel(), coef.numel()) or mb >= 2**31:
        raise ValueError(f"scatter_probe: mb={mb} exceeds the {idx.numel()} ids")
    if rows == 0 or d == 0:
        return torch.empty(rows, d, dtype=torch.float32, device=h.device)
    buf = torch.empty(rows * d + SCATTER_CTAS, dtype=torch.float32, device=h.device)
    out = buf[:rows * d].view(rows, d)
    _call("scatter_probe", idx.data_ptr(), coef.data_ptr(), h.data_ptr(), out.data_ptr(),
          out.data_ptr() + 4 * rows * d, rows, mb, d, SCATTER_CTAS, _stream(dev))
    return out


# taa_lanes puts the table's rows (or row groups) on the grid's second
# dimension. The scans cut the table into tiles of SCAN_CHUNK_ROWS rows (a
# chunk, 8 a warp) by SCAN_TILE_COLS columns (csrc/taa_probe.cu), whose ints
# hold piece's S + 1 rows and the count of tiles: both below SCAN_INT_LIMIT.
TAA_LANES_MAX_ROWS = 65535
SCAN_CHUNK_ROWS = 128
SCAN_WARP_ROWS = 8
SCAN_TILE_COLS = 128
SCAN_INT_LIMIT = 2**31
# The forms of taa_rows (csrc/taa_probe.cu), by their number in the C interface.
TAA_FORMS = ("general", "row")


def taa_rows_form(strides, s: int, l: int, steps: int, idx_numel: int, itemsize: int,
                  tab_ptr: int = 0, out_ptr: int = 0) -> str:
    """Which form of ``taa_rows`` takes a call, from what the launcher can read:
    'row' where one index gives a whole row (sj == 0), a row is a whole number of
    4-column groups that are aligned in the table (16 bytes of f32, 8 of bf16)
    and in out, and the table and the index array are below 2^31 elements
    (32-bit offsets); 'general' for everything else, a full index included."""
    if strides[1] == 0 and l % 4 == 0 and s * l < 2**31 and idx_numel < 2**31 \
            and tab_ptr % (4 * itemsize) == 0 and out_ptr % 16 == 0:
        return "row"
    return "general"


# The forms of taa_lanes (csrc/taa_probe.cu), by their number in the C
# interface; the general form's CTA walks TAA_LANE_TILE columns.
TAA_LANES_FORMS = ("general", "group")
TAA_LANE_TILE = 1024


class LanesForm(NamedTuple):
    form: str   # one of TAA_LANES_FORMS
    rows: int   # table rows a CTA stages (the group form's R)
    tile: int   # columns a CTA walks


def _group_stage_bytes(l: int, column_bytes: int) -> int:
    """Shared memory of a group: its columns, ``column_bytes`` each, rounded up
    to the run of one 128-byte wavefront that the stage's swizzle permutes."""
    run = 128 // column_bytes
    return -(-l // run) * run * column_bytes


@functools.lru_cache(maxsize=256)
def taa_lanes_form(strides: tuple, s: int, l: int, steps: int, itemsize: int) -> LanesForm:
    """Which form of ``taa_lanes`` takes a call: 'group' where the index does
    not depend on the row (si == 0) and its offsets fit 32 bits, 'general' for
    everything else (a full index, or a row too long to stage).

    A group stages R rows, 2, 4 or 8 bf16 or 1, 2 or 4 f32 (4 to 16 bytes of
    a column), within a block's shared memory; its column tile makes the
    groups × tiles about one CTA an SM (measured faster than more CTAs of
    smaller stages, whose stages add traffic). Of the R that fit, it takes the
    one whose traffic is least: each CTA reads its group's stage from L2, and
    each group reads the index loads of its columns (L × steps ints); the
    larger R where two tie."""
    si, sj, sk = strides
    if si != 0 or (l - 1) * sj + (steps - 1) * sk >= 2**31:
        return LanesForm("general", 1, TAA_LANE_TILE)
    best = None
    for rows in (16 // itemsize, 8 // itemsize, 4 // itemsize):
        stage = _group_stage_bytes(l, rows * itemsize)
        if stage > SMEM_BLOCK_BYTES:
            continue
        groups = -(-s // rows)
        tiles = max(1, min(-(-l // 32), H100_SMS // groups))
        per_tile = -(-l // tiles)
        tile = -(-per_tile // 32) * 32  # whole warps
        traffic = -(-l // tile) * groups * stage + groups * 4 * l * steps
        if best is None or traffic < best[0]:
            best = (traffic, LanesForm("group", rows, tile))
    return LanesForm("general", 1, TAA_LANE_TILE) if best is None else best[1]


def _taa(name: str, idx, strides, tab, steps: int, reps: int) -> torch.Tensor:
    dev = _on_cuda(tab, name)
    _check(idx, "idx", torch.int32, dev)
    if tab.dtype is not torch.float32 and tab.dtype is not torch.bfloat16:
        raise TypeError(f"tab must be float32 or bfloat16, got {tab.dtype}")
    _check(tab, "tab", tab.dtype, dev)
    if tab.dim() != 2:
        raise ValueError(f"tab must be [S, L], got {tuple(tab.shape)}")
    s, l = tab.shape
    si, sj, sk = strides
    if steps < 1 or reps < 1 or si < 0 or sj < 0 or sk < 0:
        raise ValueError(f"{name}: steps and reps must be positive, strides non-negative")
    n_idx = idx.numel()
    if s and l and (s - 1) * si + (l - 1) * sj + (steps - 1) * sk >= n_idx:
        raise ValueError(f"{name}: strides {(si, sj, sk)} over [{s}, {l}, {steps}] run past "
                         f"the {n_idx} indices")
    rows = name == "taa_rows"
    if not rows and s > TAA_LANES_MAX_ROWS:
        raise ValueError(f"taa_lanes takes at most {TAA_LANES_MAX_ROWS} table rows, got {s}")
    out = torch.empty(s, l, dtype=torch.float32, device=tab.device)
    if s == 0 or l == 0:
        return out
    bf16 = tab.dtype is torch.bfloat16
    tab_ptr, out_ptr = tab.data_ptr(), out.data_ptr()
    if rows:
        form = TAA_FORMS.index(taa_rows_form(strides, s, l, steps, n_idx, 2 if bf16 else 4,
                                             tab_ptr, out_ptr))
        _call(name, idx.data_ptr(), si, sj, sk, tab_ptr, bf16, out_ptr, s, l, steps, reps,
              form, _stream(dev))
    else:
        form = taa_lanes_form(tuple(strides), s, l, steps, 2 if bf16 else 4)
        _call(name, idx.data_ptr(), si, sj, sk, tab_ptr, bf16, out_ptr, s, l, steps, reps,
              TAA_LANES_FORMS.index(form.form), form.rows, form.tile, _stream(dev))
    return out


def taa_rows(idx, strides, tab, steps: int = 1, reps: int = 1) -> torch.Tensor:
    """Launch the axis-0 element gather: out[i, j] = Σ_{r<reps} Σ_{k<steps}
    tab[idx[i·si + j·sj + k·sk], j] in f32, for ``strides`` (si, sj, sk) in
    elements of the int32 ``idx``, in the form that ``taa_rows_form`` names.
    The indices must lie in [0, S): the kernel does not check them."""
    return _taa("taa_rows", idx, strides, tab, steps, reps)


def taa_lanes(idx, strides, tab, steps: int = 1, reps: int = 1) -> torch.Tensor:
    """Launch the axis-1 element gather: out[i, j] = Σ_{r<reps} Σ_{k<steps}
    tab[i, idx[i·si + j·sj + k·sk]] in f32, in the form that ``taa_lanes_form``
    names. The indices must lie in [0, L)."""
    return _taa("taa_lanes", idx, strides, tab, steps, reps)


def _scan_totals(s: int, l: int, device) -> torch.Tensor:
    """The scans' scratch: a row of SCAN_TILE_COLS totals for each (column
    tile, chunk), then two rows a column tile that carry the fold's running
    value from one wave of tiles to the next. Raises for a table past the
    kernel's ints (``SCAN_INT_LIMIT``)."""
    chunks, tiles = -(-s // SCAN_CHUNK_ROWS), -(-l // SCAN_TILE_COLS)
    if s + 1 >= SCAN_INT_LIMIT or chunks * tiles >= SCAN_INT_LIMIT:
        raise ValueError(f"the column scans take fewer than {SCAN_INT_LIMIT - 1} rows and "
                         f"{SCAN_INT_LIMIT} tiles of {SCAN_CHUNK_ROWS}x{SCAN_TILE_COLS}, "
                         f"got [{s}, {l}]")
    return torch.empty((chunks + 2) * tiles, SCAN_TILE_COLS, dtype=torch.float32, device=device)


def cumsum_cols(tab, reps: int = 1) -> torch.Tensor:
    """Launch the column scan: ``reps`` additions of cumsum(tab, axis 0), [S, L]
    f32, in one cooperative launch (the order of its additions is
    ``probes.taa.scan_order_plain``'s)."""
    dev = _on_cuda(tab, "cumsum_cols")
    _check(tab, "tab", torch.float32, dev)
    if tab.dim() != 2 or reps < 1:
        raise ValueError("cumsum_cols: tab must be [S, L] and reps positive")
    s, l = tab.shape
    out = torch.empty(s, l, dtype=torch.float32, device=tab.device)
    if s == 0 or l == 0:
        return out
    totals = _scan_totals(s, l, tab.device)
    _call("cumsum_cols", tab.data_ptr(), out.data_ptr(), totals.data_ptr(), s, l, reps,
          _stream(dev))
    return out


def piece(ids, coef, begin, end, tab, reps: int = 1) -> torch.Tensor:
    """Launch the piece: with cs = [0; cumsum(tab[ids]·coef, axis 0)], ``reps``
    additions of cs[end] − cs[begin], [S, L] f32, in one cooperative launch:
    the scan in ``cumsum_cols``' order into an [S+1, L] scratch, a grid
    barrier, then the boundary rows. ``ids``, ``begin``, ``end`` (int32) and
    ``coef`` (f32) hold S values each; ids lie in [0, S), begin and end in
    [0, S], in any order (the kernel does not check them)."""
    dev = _on_cuda(tab, "piece")
    _check(tab, "tab", torch.float32, dev)
    _check(ids, "ids", torch.int32, dev)
    _check(begin, "begin", torch.int32, dev)
    _check(end, "end", torch.int32, dev)
    _check(coef, "coef", torch.float32, dev)
    if tab.dim() != 2 or reps < 1:
        raise ValueError("piece: tab must be [S, L] and reps positive")
    s, l = tab.shape
    if ids.numel() != s or coef.numel() != s or begin.numel() != s or end.numel() != s:
        raise ValueError(f"piece: ids, coef, begin and end must hold {s} values each")
    out = torch.empty(s, l, dtype=torch.float32, device=tab.device)
    if s == 0 or l == 0:
        return out
    totals = _scan_totals(s, l, tab.device)
    cs = torch.empty(s + 1, l, dtype=torch.float32, device=tab.device)
    _call("piece", ids.data_ptr(), coef.data_ptr(), begin.data_ptr(), end.data_ptr(),
          tab.data_ptr(), out.data_ptr(), cs.data_ptr(), totals.data_ptr(), s, l, reps,
          _stream(dev))
    return out


# The dense layer-0 kernel (csrc/layer0_pair.cu): a launch of the flat or
# the chunked way computes LAYER0_COLS output columns, one of the wide way
# LAYER0_WIDE_COLS (W's columns past H zero-filled); a wider W takes a launch
# per that many columns.
LAYER0_COLS = 16
LAYER0_WIDE_COLS = 64


# The flat way: a CTA of LAYER0_FLAT_WARPS computing warps (and one that
# copies) over blocks of 32 rows. The wide way: LAYER0_WIDE_WARPS warps, each
# streaming its own tiles of 32 rows in chunks of 32 columns.
LAYER0_FLAT_WARPS = 8
LAYER0_WIDE_WARPS = 8
LAYER0_PATHS = ("chunked", "flat", "wide")


def layer0_flat_smem(f: int, itemsize: int, with_eval: bool) -> int:
    """Shared memory of the flat way: two stages, each a block of 32 rows and
    16 bytes a masked read past it may touch; W whole, its rows zero-filled to
    a multiple of 8; the computing warps' partial sums, a row of them padded to
    an odd number of words; the stages' four barriers."""
    stage = -(-32 * f * itemsize // 16) * 16 + 16
    sums = 4 * LAYER0_FLAT_WARPS * 32 * ((2 if with_eval else 1) * LAYER0_COLS + 1)
    return 2 * stage + 4 * -(-f // 8) * 8 * LAYER0_COLS + sums + 4 * 8


def layer0_wide_smem(f: int, itemsize: int) -> int:
    """Shared memory of the wide way: W whole in f32, and each warp's two
    stages of 32 rows of a chunk, a row 32 elements and one 4-byte word."""
    return 4 * f * LAYER0_WIDE_COLS + 4 * LAYER0_WIDE_WARPS * 2 * 32 * (32 * itemsize // 4 + 1)


def layer0_path(f: int, h: int, itemsize: int, with_eval: bool, x_ptr: int) -> str:
    """Which way the dense layer-0 kernel takes through x for W [F, H]:
    'wide' (a thread a row and all of 64 columns, W whole) where H is above
    LAYER0_COLS, its shared memory fits and x starts on 16 bytes; else 'flat'
    (blocks of 32 whole rows as one range, W whole) where its shared memory
    fits and x starts on 16 bytes; else 'chunked' (chunks of 64 columns)."""
    if x_ptr % 16 == 0:
        if h > LAYER0_COLS and layer0_wide_smem(f, itemsize) <= SMEM_BLOCK_BYTES:
            return "wide"
        if layer0_flat_smem(f, itemsize, with_eval) <= SMEM_BLOCK_BYTES:
            return "flat"
    return "chunked"


def dropout_keep(rate: float) -> tuple[float, float, int, int, int]:
    """The layer-0 kernel's dropout at ``rate`` (0 < rate <= 1): q = 1 - rate
    in f32 (torch compares its uniforms with q in f32); 1/q; whether q is a
    power of two (then x·(1/q) is x/q exactly); the bits of a uniform an
    element takes, 8 where q·2^8 is a whole number (rate 0.5: 16 elements a
    Philox call, ``ops.matmul.layer0_keep``) and else 32; and the threshold
    below which those bits keep their element, q·2^bits (rounded at 32 bits):
    the keep share is q."""
    q = float(np.float32(1.0 - rate))
    pow2 = q > 0.0 and math.frexp(q)[0] == 0.5
    bits = 8 if (q * 256.0).is_integer() else 32
    thresh = int(q * 256.0) if bits == 8 else min(round(q * 2.0**32), 2**32 - 1)
    return q, (1.0 / q if pow2 else 0.0), int(pow2), thresh, bits


def layer0_pair(x, w, seeds, rate: float, with_eval: bool):
    """Launch the dense layer-0 kernel on x [N, F] (f32 or bf16) and f32 W
    [F, H]: returns (xd, zt, ze), xd = x with dropout at ``rate`` (the mask
    drawn in the kernel by Philox under ``seeds``, two int64 on the device:
    key and counter offset), zt = xd @ W and, when ``with_eval``, ze = x @ W,
    else None; all in x's type, the products summed in f32 (W rounded to bf16
    for bf16 x)."""
    dev = _on_cuda(x, "layer0_pair")
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    _check(x, "x", x.dtype, dev)
    _check(w, "w", torch.float32, dev)
    _check(seeds, "seeds", torch.int64, dev)
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] or seeds.numel() != 2:
        raise ValueError(f"layer0_pair: x [N, F], W [F, H] and 2 seeds, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {seeds.numel()}")
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"layer0_pair: dropout rate must lie in (0, 1], got {rate}")
    (n, f), h = x.shape, w.shape[1]
    xd = torch.empty_like(x)
    zt = torch.empty(n, h, dtype=x.dtype, device=x.device)
    ze = torch.empty_like(zt) if with_eval else None
    if n == 0 or h == 0:
        return xd, zt, ze
    if f == 0:
        return xd, zt.zero_(), None if ze is None else ze.zero_()
    q, inv_q, pow2, thresh, bits = dropout_keep(rate)
    x_ptr = x.data_ptr()
    path = layer0_path(f, h, x.element_size(), with_eval, x_ptr)
    cols = LAYER0_WIDE_COLS if path == "wide" else LAYER0_COLS
    for h_off in range(0, h, cols):
        _call("layer0_pair", x_ptr, w.data_ptr(), seeds.data_ptr(), xd.data_ptr(),
              zt.data_ptr(), None if ze is None else ze.data_ptr(), n, f, h, h_off,
              min(cols, h - h_off), LAYER0_PATHS.index(path), q, inv_q, pow2, thresh, bits,
              int(h_off == 0), dtype_code(x.dtype), _stream(dev))
    return xd, zt, ze


# The GAT's attention kernels (csrc/gat_attention.cu): a lane holds at most
# GAT_LANE_FLOATS floats of its head, as STEPS pieces of VEC (the layouts built);
# in the backward passes (``wide``) up to GAT_WIDE_FLOAT4 float4.
GAT_LANE_FLOATS = 8
GAT_WIDE_FLOAT4 = 4


def gat_layout(heads: int, ld: int, *bases: int,
               wide: bool = False) -> tuple[int, int, int, int]:
    """The attention kernels' lane split for K = ``heads`` heads whose rows
    hold ``ld`` floats a head (F' features, padded or not), as (VEC, L2, G,
    STEPS): VEC the widest load (4, 2 or 1 floats) that divides ``ld`` and
    aligns every base; L2 lanes a head, the least power of two at which a lane
    holds at most ``GAT_LANE_FLOATS`` floats (with ``wide`` and VEC 4,
    ``GAT_WIDE_FLOAT4`` float4), as STEPS pieces of VEC (a power of two); G =
    K·L2 lanes a slot, rounded up to a power of two (32 / G slots side by
    side). A split past 32 lanes a slot is refused. The backward passes take
    ``wide``: at 1 x 41 padded to 44, 4 lanes of 4 float4 and 8 slots where
    the forward takes 8 lanes of 2 and 4 slots (their per-slot butterflies
    lose a step; the forward, which has none, was slower so)."""
    vec = next(v for v in (4, 2, 1) if ld % v == 0 and not any(b % (4 * v) for b in bases))
    cap = 4 * GAT_WIDE_FLOAT4 if wide and vec == 4 else GAT_LANE_FLOATS
    pieces = ld // vec
    for l2 in (1, 2, 4, 8, 16, 32):
        steps = 1 << (-(-pieces // l2) - 1).bit_length()
        g = 1 << (heads * l2 - 1).bit_length()
        if vec * steps <= cap and g <= 32:
            return vec, l2, g, steps
    raise ValueError(f"the attention kernels take at most 32 lanes a slot and "
                     f"{cap} floats a lane; {heads} heads of {ld} floats do not fit")


def gat_keep(rate: float) -> tuple[float, float, int]:
    """The attention dropout at ``rate`` (0 <= rate < 1): q = 1 - rate in f32,
    1/q in f32 (a kept weight is multiplied by it), and the threshold below
    which a 32-bit word keeps its weight, q·2^32 rounded (at most 2^32 - 1)."""
    q = float(np.float32(1.0 - rate))
    return q, float(np.float32(1.0 / q)), min(round(q * 2.0**32), 2**32 - 1)


def _gat_check(name, plan, partial_rows, tensors, heads: int, seeds):
    """The launch's device index and the checks every attention launcher
    makes: the work list and columns of ``plan``, its partials' rows, the f32
    ``tensors`` {name: (tensor, rows, columns)}, the seeds."""
    z = tensors["z"][0]
    dev = _on_cuda(z, name)
    for what in ("work_beg", "work_len", "work_dst", "split_rows", "split_ptr", "cols"):
        _check(getattr(plan, what), what, torch.int32, dev)
    _check(partial_rows, "partial_rows", torch.int32, dev)
    for what, (t, rows, cols) in tensors.items():
        _check(t, what, torch.float32, dev)
        if t.numel() != rows * cols:
            raise ValueError(f"{name}: {what} must be [{rows}, {cols}], got {tuple(t.shape)}")
    if seeds is not None:
        _check(seeds, "seeds", torch.int64, dev)
        if seeds.numel() != 2:
            raise ValueError(f"{name}: seeds must be 2 int64, got {seeds.numel()}")
    n_items = plan.work_beg.numel()
    if plan.work_len.numel() != n_items or plan.work_dst.numel() != n_items \
            or plan.split_ptr.numel() != plan.split_rows.numel() + 1 \
            or partial_rows.numel() != plan.n_partials or heads < 1:
        raise ValueError(f"{name}: inconsistent work list")
    return dev


def _gat_common(plan, partial_rows):
    return (plan.work_beg.data_ptr(), plan.work_len.data_ptr(), plan.work_dst.data_ptr(),
            plan.work_beg.numel(), partial_rows.data_ptr(), plan.split_rows.data_ptr(),
            plan.split_ptr.data_ptr(), plan.split_rows.numel(), plan.cols.data_ptr())


def _gat_call(name: str, layout, *args) -> None:
    """``_call``, and the launch counted under its lane split in ``gat_layouts``."""
    vec, l2, _, steps = layout
    _call(name, *args)
    key = (name, vec, l2, steps)
    gat_layouts[key] = gat_layouts.get(key, 0) + 1


def gat_forward(plan, partial_rows, z, sl, sr, heads: int, slope: float, rate: float,
                seeds=None, with_stats: bool = True):
    """Launch the attention's forward over ``plan`` (ops/ell.py ``EllPlan``,
    row i gathering the rows of its slots): out [n, K·F'] from z [n, K·F'] and
    the scores sl, sr [n, K], each row's softmax over its slots, the attention
    dropout at ``rate`` under ``seeds`` (two int64 on the device; None: none);
    with ``with_stats`` also each row's max and sum [n, K, 2], else None."""
    n, k = plan.n_nodes, heads
    d = z.shape[-1] if z.dim() == 2 else -1
    if d % k or z.dim() != 2:
        raise ValueError(f"gat_forward: z must be [n, K·F'] with K = {k}, got {tuple(z.shape)}")
    dev = _gat_check("gat_forward", plan, partial_rows,
                     {"z": (z, n, d), "sl": (sl, n, k), "sr": (sr, n, k)}, k, seeds)
    out = torch.empty(n, d, dtype=torch.float32, device=z.device)
    stats = torch.empty(n, k, 2, dtype=torch.float32, device=z.device) if with_stats else None
    partial = torch.empty(plan.n_partials * (d + 2 * k), dtype=torch.float32, device=z.device)
    if n == 0 or d == 0:
        return out, stats
    layout = gat_layout(k, d // k, z.data_ptr(), out.data_ptr(), partial.data_ptr())
    _, inv_q, thresh = gat_keep(rate if seeds is not None else 0.0)
    _gat_call("gat_forward", layout, *_gat_common(plan, partial_rows), z.data_ptr(),
              sl.data_ptr(), sr.data_ptr(), None if seeds is None else seeds.data_ptr(),
              out.data_ptr(), None if stats is None else stats.data_ptr(), partial.data_ptr(),
              plan.n_partials, k, d // k, *layout, slope, inv_q, thresh, _stream(dev))
    return out, stats


def gat_rows(plan, partial_rows, g, z, sl, sr, stats, heads: int, slope: float, rate: float,
             seeds=None):
    """Launch the backward's row pass over ``plan``: from g, the gradient of
    the forward's out, node [n, K, 4] = (sl, the row's max, the reciprocal of
    its sum, A) and dsl [n, K], the gradient of sl (A = Σ_j a·da, the
    softmax's row term)."""
    n, k = plan.n_nodes, heads
    d = z.shape[-1] if z.dim() == 2 else -1
    if d % k or z.dim() != 2:
        raise ValueError(f"gat_rows: z must be [n, K·F'] with K = {k}, got {tuple(z.shape)}")
    dev = _gat_check("gat_rows", plan, partial_rows,
                     {"z": (z, n, d), "g": (g, n, d), "sl": (sl, n, k), "sr": (sr, n, k),
                      "stats": (stats, n, 2 * k)}, k, seeds)
    node = torch.empty(n, k, 4, dtype=torch.float32, device=z.device)
    dsl = torch.empty(n, k, dtype=torch.float32, device=z.device)
    partial = torch.empty(plan.n_partials * 3 * k, dtype=torch.float32, device=z.device)
    if n == 0 or d == 0:
        return node, dsl
    layout = gat_layout(k, d // k, z.data_ptr(), g.data_ptr(), wide=True)
    _, inv_q, thresh = gat_keep(rate if seeds is not None else 0.0)
    _gat_call("gat_rows", layout, *_gat_common(plan, partial_rows), g.data_ptr(), z.data_ptr(),
              sl.data_ptr(), sr.data_ptr(), stats.data_ptr(),
              None if seeds is None else seeds.data_ptr(), node.data_ptr(), dsl.data_ptr(),
              partial.data_ptr(), k, d // k, *layout, slope, inv_q, thresh, _stream(dev))
    return node, dsl


def gat_cols(plan_t, partial_rows_t, rev, g, z, sr, node, heads: int, slope: float,
             rate: float, seeds=None):
    """Launch the backward's column pass over ``plan_t``, the plan of Âᵀ
    (row j, a slot for each i whose row holds j), with ``rev`` its reverse
    map into the forward plan's slots: dz [n, K·F'], the aggregation's part of
    z's gradient, and dsr [n, K], the gradient of sr."""
    n, k = plan_t.n_nodes, heads
    d = z.shape[-1] if z.dim() == 2 else -1
    if d % k or z.dim() != 2:
        raise ValueError(f"gat_cols: z must be [n, K·F'] with K = {k}, got {tuple(z.shape)}")
    dev = _gat_check("gat_cols", plan_t, partial_rows_t,
                     {"z": (z, n, d), "g": (g, n, d), "sr": (sr, n, k),
                      "node": (node, n, 4 * k)}, k, seeds)
    _check(rev, "rev", torch.int32, dev)
    if rev.numel() != plan_t.cols.numel():
        raise ValueError(f"gat_cols: rev must hold a slot for each of {plan_t.cols.numel()}")
    dz = torch.empty(n, d, dtype=torch.float32, device=z.device)
    dsr = torch.empty(n, k, dtype=torch.float32, device=z.device)
    partial = torch.empty(plan_t.n_partials * (d + k), dtype=torch.float32, device=z.device)
    if n == 0 or d == 0:
        return dz, dsr
    layout = gat_layout(k, d // k, z.data_ptr(), g.data_ptr(), dz.data_ptr(),
                        partial.data_ptr(), wide=True)
    _, inv_q, thresh = gat_keep(rate if seeds is not None else 0.0)
    _gat_call("gat_cols", layout, *_gat_common(plan_t, partial_rows_t), rev.data_ptr(),
              g.data_ptr(), z.data_ptr(), sr.data_ptr(), node.data_ptr(),
              None if seeds is None else seeds.data_ptr(), dz.data_ptr(), dsr.data_ptr(),
              partial.data_ptr(), plan_t.n_partials, k, d // k, *layout, slope, inv_q, thresh,
              _stream(dev))
    return dz, dsr


# GCNII's convolution epilogue (csrc/gcnii_epilogue.cu): built for rows of
# these widths.
GCNII_EPILOGUE_WIDTHS = (64,)


def gcnii_dropout(rate: float) -> tuple[float, int]:
    """The epilogue's dropout at ``rate`` (0 <= rate <= 1): the factor of a
    kept value, 1/q in f32 for q = 1 - rate in f32, divided in f32 as ATen
    does for x / (1 - rate) with a host scalar on the card (0 where q is 0:
    nothing is kept); and the threshold below which a 32-bit word keeps its
    element, q·2^32 (2^32 at rate 0: every word)."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"gcnii_epilogue: dropout rate must lie in [0, 1], got {rate}")
    q = np.float32(1.0 - rate)
    return (float(np.float32(1.0) / q) if q > 0 else 0.0), round(float(q) * 2.0**32)


def _gcnii_check(name: str, rows: dict, w) -> int:
    """The device index of the epilogue's launch: each of ``rows`` ({name:
    tensor}) f32 [n, H] on one card, contiguous, for one H of
    ``GCNII_EPILOGUE_WIDTHS``; W f32 [H, H]."""
    first = next(iter(rows.values()))
    dev = _on_cuda(first, name)
    for what, t in rows.items():
        _check(t, what, torch.float32, dev)
    _check(w, "w", torch.float32, dev)
    n, h = first.shape if first.dim() == 2 else (-1, -1)
    if h not in GCNII_EPILOGUE_WIDTHS or tuple(w.shape) != (h, h) \
            or any(tuple(t.shape) != (n, h) for t in rows.values()):
        raise ValueError(f"{name}: rows [n, H] with H in {GCNII_EPILOGUE_WIDTHS} and W [H, H], "
                         f"got {[tuple(t.shape) for t in rows.values()]}, {tuple(w.shape)}")
    return dev


def gcnii_epilogue(st, se, w, seeds, theta: float, rate: float, concat: bool):
    """Launch GCNII's convolution epilogue on the blended passes st, se (f32
    [n, H]) and the convolution's W (f32 [H, H]): returns (ht, he, keep,
    relu). ht = keep ? ReLU(z_t) / (1 - rate) : 0 and he = ReLU(z_e), z =
    theta·(s·W) + (1 - theta)·s of each half, are [n, H] views of one [n, 2H]
    buffer side by side where ``concat`` (the next blended pass's input), else
    tensors of their own; keep is the mask drawn in the kernel by Philox
    under ``seeds`` (two int64 on the device: key and counter offset), bool
    [n, H]; relu holds z_t > 0 as bits, int32 [n, H/32] (bit c % 32 of word c
    / 32 is column c)."""
    dev = _gcnii_check("gcnii_epilogue", {"st": st, "se": se}, w)
    _check(seeds, "seeds", torch.int64, dev)
    if seeds.numel() != 2:
        raise ValueError(f"gcnii_epilogue: 2 seeds, got {seeds.numel()}")
    scale, thresh = gcnii_dropout(rate)
    n, h = st.shape
    if concat:
        both = torch.empty(n, 2 * h, dtype=torch.float32, device=st.device)
        ht, he = both[:, :h], both[:, h:]
    else:
        ht, he = torch.empty_like(st), torch.empty_like(st)
    keep = torch.empty(n, h, dtype=torch.bool, device=st.device)
    relu = torch.empty(n, -(-h // 32), dtype=torch.int32, device=st.device)
    if n:
        _call("gcnii_epilogue", st.data_ptr(), se.data_ptr(), w.data_ptr(), seeds.data_ptr(),
              ht.data_ptr(), he.data_ptr(), ht.stride(0), keep.data_ptr(), relu.data_ptr(), n,
              h, theta, 1.0 - theta, scale, thresh, _stream(dev))
    return ht, he, keep, relu


def gcnii_epilogue_bwd(g, keep, relu, w, theta: float, rate: float):
    """Launch the epilogue's backward for the training half: g (f32 [n, H]),
    the gradient of ht, with the forward's keep and relu and W: returns (gs,
    gz), gz = [z_t > 0]·(keep ? g / (1 - rate) : 0) and gs = theta·(gz·Wᵀ) +
    (1 - theta)·gz, f32 [n, H]."""
    dev = _gcnii_check("gcnii_epilogue_bwd", {"g": g}, w)
    n, h = g.shape
    _check(keep, "keep", torch.bool, dev)
    _check(relu, "relu", torch.int32, dev)
    if tuple(keep.shape) != (n, h) or tuple(relu.shape) != (n, -(-h // 32)):
        raise ValueError(f"gcnii_epilogue_bwd: keep [n, H] and relu [n, H/32], got "
                         f"{tuple(keep.shape)}, {tuple(relu.shape)}")
    scale, _ = gcnii_dropout(rate)
    gs, gz = torch.empty_like(g), torch.empty_like(g)
    if n:
        _call("gcnii_epilogue_bwd", g.data_ptr(), keep.data_ptr(), relu.data_ptr(), w.data_ptr(),
              gz.data_ptr(), gs.data_ptr(), n, h, theta, 1.0 - theta, scale, _stream(dev))
    return gs, gz
