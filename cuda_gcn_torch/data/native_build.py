"""The native graph-build steps (``csrc/host/gcn_build.cpp``) that
data/graph.py takes at ``NATIVE_BUILD_MIN_NNZ`` edges and more.

The port's counterpart of cuda_gcn_tpu/data/native_build.py, bit for bit with
the numpy code it replaces: ``norm_coef`` (``normalization_coefficients``),
``transpose_coo`` (the stable argsort by destination) and ``select_tiles``.
Selection differs from the JAX package's: it returns the selected tile ids
and each edge's tile rank, and writes no tiles, since ``build_graph``
scatters them straight into device memory; so it does not depend on the
tile dtype, and repeated edges still accumulate in f32 on the device.

Outputs are numpy arrays over the library's buffers, without a copy
(``native.wrap``): at 87M edges each is 0.35-0.7 GB. ``torch.from_numpy`` over
one keeps it, and so the buffer, alive until the tensor is gone.
"""

from __future__ import annotations

import ctypes

import numpy as np

from cuda_gcn_torch.data import native

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)


def _c(a: np.ndarray, dtype, ptype):
    """``a`` as a contiguous array of ``dtype`` (a copy only if it is not one)
    and its pointer."""
    a = np.ascontiguousarray(a, dtype=dtype)
    return a, a.ctypes.data_as(ptype)


def _check_ids(ids: np.ndarray, n: int, what: str) -> None:
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise ValueError(f"{what} outside [0, {n})")


def _check_coo(src, dst, n, coef=None) -> None:
    if len(src) != len(dst) or (coef is not None and len(coef) != len(src)):
        raise ValueError(f"COO arrays of unequal lengths: {len(src)}, {len(dst)}"
                         + ("" if coef is None else f", {len(coef)}"))
    _check_ids(src, n, "src")
    _check_ids(dst, n, "dst")


def norm_coef(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-edge 1/sqrt(rowlen(src) * rowlen(dst)), in double and rounded once
    to f32: ``graph.normalization_coefficients``'s numpy result."""
    lib = native.library("gcn_build")
    n = len(indptr) - 1
    indptr, ip = _c(indptr, np.int64, _i64p)
    indices, ix = _c(indices, np.int64, _i64p)
    if int(indptr[-1]) != len(indices):
        raise ValueError(f"indptr ends at {int(indptr[-1])}, indices has {len(indices)}")
    _check_ids(indices, n, "indices")
    out = _f32p()
    if lib.gcn_norm_coef(ip, ix, n, ctypes.byref(out)) != 0:
        raise MemoryError("gcn_norm_coef could not allocate its output")
    return native.wrap(out, len(indices), np.float32, lib.gcn_build_free)


def transpose_coo(src: np.ndarray, dst: np.ndarray, coef: np.ndarray, n: int):
    """The COO sorted stably by ``dst``: (dst[perm], src[perm], coef[perm])
    for ``perm = np.argsort(dst, kind='stable')``, by a counting sort."""
    lib = native.library("gcn_build")
    _check_coo(src, dst, n, coef)
    src, s = _c(src, np.int64, _i64p)
    dst, d = _c(dst, np.int64, _i64p)
    coef, w = _c(coef, np.float32, _f32p)
    ts, td, tc = _i64p(), _i64p(), _f32p()
    if lib.gcn_transpose_coo(s, d, w, len(src), n, ctypes.byref(ts), ctypes.byref(td),
                             ctypes.byref(tc)) != 0:
        raise MemoryError("gcn_transpose_coo could not allocate its outputs")
    free, m = lib.gcn_build_free, len(src)
    return (native.wrap(ts, m, np.int64, free), native.wrap(td, m, np.int64, free),
            native.wrap(tc, m, np.float32, free))


def select_tiles(src: np.ndarray, dst: np.ndarray, n: int, tb: int, min_edges: int,
                 max_tiles: int, pair_close: bool):
    """The densest [tb, tb] tiles: every tile with at least ``min_edges``
    edges, cut densest-first (count descending, id ascending) to
    ``max_tiles``, in ascending id order; with ``pair_close``, less each
    off-diagonal tile whose mirror did not survive the cut. Returns (ids, rank):
    ``ids`` (k,) int64 tile ids ``block_row * T + block_col``, ``rank`` (nnz,)
    int32, each edge's position in ``ids`` or -1 for a residual edge."""
    lib = native.library("gcn_build")
    _check_coo(src, dst, n)
    src, s = _c(src, np.int64, _i64p)
    dst, d = _c(dst, np.int64, _i64p)
    ids, rank, k = _i64p(), _i32p(), ctypes.c_int64()
    rc = lib.gcn_select_tiles(s, d, len(src), n, tb, min_edges, max_tiles, int(pair_close),
                              ctypes.byref(ids), ctypes.byref(k), ctypes.byref(rank))
    if rc != 0:
        raise (MemoryError if rc == 1 else ValueError)(f"gcn_select_tiles failed (rc={rc})")
    free = lib.gcn_build_free
    return native.wrap(ids, k.value, np.int64, free), native.wrap(rank, len(src), np.int32, free)
