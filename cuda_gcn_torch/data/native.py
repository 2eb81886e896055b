"""The native C++ host code: the text parser, label propagation and the
graph-build steps, bound with ctypes.

The port's counterpart of cuda_gcn_tpu/data/native.py. Its sources are its own
copies in ``cuda_gcn_torch/csrc/host/``: ``gcn_parser.cpp`` and
``gcn_lpa.cpp`` as in the root ``csrc/``, and ``gcn_build.cpp``, whose tile
selection writes no tiles (data/native_build.py). At first use each source is
compiled by ``g++`` (``CXX_FLAGS``, plus ``-pthread`` for LPA) into
``build/native/lib<source>.<hash>.so`` at the repository root, the hash over
the source and its flags, so an edited source is rebuilt and a stale library
never loads. Each process compiles to a temporary file of its own and renames
it into place, so processes that build at once leave one whole library.
Nothing is built or loaded when this module is imported.

There is no fallback: a missing ``g++`` or a failed build raises with the
compiler's output. The numpy code stays the oracle, reached only by asking for
it: ``use_native=False`` (data/parser.py), ``prefer_native=False``
(data/reorder.py), or a graph under ``NATIVE_BUILD_MIN_NNZ`` edges
(data/graph.py).

Every buffer that the library allocates is wrapped without a copy (``wrap``):
a numpy array over it, freed by the library when the last array that views it
is collected.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref

import numpy as np

from cuda_gcn_torch.data.dataset import CSR, GCNDataset

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC_DIR = os.path.join(_PKG_DIR, "csrc", "host")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
SOURCES = {"gcn_parser": (), "gcn_lpa": ("-pthread",), "gcn_build": ()}

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_int, _i32, _i64 = ctypes.c_int, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {  # source -> {C function: (argtypes, restype)}
    "gcn_parser": {
        "gcn_parse_graph": ([ctypes.c_char_p, ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
                             _i64p, _i64p], _int),
        "gcn_parse_svmlight": ([ctypes.c_char_p, ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
                                ctypes.POINTER(_f32p), ctypes.POINTER(_i32p), _i64p, _i64p,
                                _i32p, _i32p], _int),
        "gcn_parse_split": ([ctypes.c_char_p, ctypes.POINTER(_i32p), _i64p], _int),
        "gcn_free": ([ctypes.c_void_p], None),
    },
    "gcn_lpa": {"gcn_lpa": ([_i64p, _i32p, _i64, _i32, _i64p], _i64)},
    "gcn_build": {
        "gcn_norm_coef": ([_i64p, _i64p, _i64, ctypes.POINTER(_f32p)], _int),
        "gcn_transpose_coo": ([_i64p, _i64p, _f32p, _i64, _i64, ctypes.POINTER(_i64p),
                               ctypes.POINTER(_i64p), ctypes.POINTER(_f32p)], _int),
        "gcn_select_tiles": ([_i64p, _i64p, _i64, _i64, _i64, _i64, _i64, _int,
                              ctypes.POINTER(_i64p), _i64p, ctypes.POINTER(_i32p)], _int),
        "gcn_build_free": ([ctypes.c_void_p], None),
    },
}
_libs: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> str:
    """Where ``name``'s library lives: its name hashes the source and the flags."""
    digest = hashlib.sha256(" ".join((*CXX_FLAGS, *SOURCES[name])).encode())
    with open(os.path.join(HOST_SRC_DIR, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{digest.hexdigest()[:12]}.so")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host code "
                           "(cuda_gcn_torch/csrc/host) is built with it; pass "
                           "use_native=False / prefer_native=False for the numpy code")
    return gxx


def build(names=None) -> dict[str, float]:
    """Compile the named sources (all of ``SOURCES`` by default) that have no
    up-to-date library, in parallel. Returns {name: seconds} for the sources
    compiled; raises with g++'s output if one fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: lib_path(n) for n in names if not os.path.exists(lib_path(n))}
    if not todo:
        return {}
    gxx = _gxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [gxx, *CXX_FLAGS, *SOURCES[name], "-o", tmp,
               os.path.join(HOST_SRC_DIR, f"{name}.cpp")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"g++ failed for {name}.cpp (rc {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """``name``'s library, built if need be, loaded once, its functions bound."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(lib_path(name))
        for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, restype
        _libs[name] = lib
    return lib


def _loads(name: str) -> bool:
    try:
        library(name)
    except (RuntimeError, OSError):
        return False
    return True


def available() -> bool:
    """Whether the native parser builds and loads here. The entry points do
    not ask: they build, and raise if that fails."""
    return _loads("gcn_parser")


def lpa_available() -> bool:
    """Whether the native LPA builds and loads here (see ``available``)."""
    return _loads("gcn_lpa")


def wrap(ptr, n: int, dtype, free) -> np.ndarray:
    """A numpy array of ``n`` values over the malloc'd buffer at ``ptr``, no
    copy. Every view of it keeps the buffer object alive, and ``free`` (the
    library's) releases the buffer once that object is collected."""
    dtype = np.dtype(dtype)
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    if not addr:
        raise MemoryError("the native host code returned no buffer")
    buf = (ctypes.c_uint8 * max(n * dtype.itemsize, 1)).from_address(addr)
    weakref.finalize(buf, free, addr)
    return np.frombuffer(buf, dtype=dtype, count=n)


def load_dataset(paths: dict) -> GCNDataset:
    """Parse ``paths['graph']``, ``['svmlight']`` and ``['split']`` natively;
    the same arrays as data/parser.py's numpy parser, values by ``strtof``."""
    lib = library("gcn_parser")
    free = lib.gcn_free

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"native parse of {paths[what]} failed (rc={rc})")

    g_indptr, g_indices = _i32p(), _i32p()
    n_nodes, g_nnz = _i64(), _i64()
    check(lib.gcn_parse_graph(paths["graph"].encode(), ctypes.byref(g_indptr),
                              ctypes.byref(g_indices), ctypes.byref(n_nodes),
                              ctypes.byref(g_nnz)), "graph")
    f_indptr, f_indices, f_values, labels = _i32p(), _i32p(), _f32p(), _i32p()
    f_rows, f_nnz = _i64(), _i64()
    input_dim, output_dim = _i32(), _i32()
    check(lib.gcn_parse_svmlight(paths["svmlight"].encode(), ctypes.byref(f_indptr),
                                 ctypes.byref(f_indices), ctypes.byref(f_values),
                                 ctypes.byref(labels), ctypes.byref(f_rows),
                                 ctypes.byref(f_nnz), ctypes.byref(input_dim),
                                 ctypes.byref(output_dim)), "svmlight")
    split, split_n = _i32p(), _i64()
    check(lib.gcn_parse_split(paths["split"].encode(), ctypes.byref(split),
                              ctypes.byref(split_n)), "split")
    n, rows, nnz = n_nodes.value, f_rows.value, f_nnz.value
    return GCNDataset(
        graph=CSR(indptr=wrap(g_indptr, n + 1, np.int32, free),
                  indices=wrap(g_indices, g_nnz.value, np.int32, free)),
        feature_index=CSR(indptr=wrap(f_indptr, rows + 1, np.int32, free),
                          indices=wrap(f_indices, nnz, np.int32, free)),
        feature_value=wrap(f_values, nnz, np.float32, free),
        label=wrap(labels, rows, np.int32, free),
        split=wrap(split, split_n.value, np.int32, free),
        num_nodes=n, input_dim=input_dim.value, output_dim=output_dim.value)


def label_propagation(indptr: np.ndarray, indices: np.ndarray, rounds: int,
                      seed_labels: np.ndarray | None = None) -> np.ndarray:
    """Up to ``rounds`` synchronous LPA rounds on all the host's cores: the
    labels of data/reorder.py's numpy LPA (modal neighbour label, ties to the
    smallest, early exit at a fixpoint), whatever the thread count. Takes int64
    ``indptr`` and int32 ``indices``; an int32 ``indices`` is not copied."""
    lib = library("gcn_lpa")
    n = len(indptr) - 1
    indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
    indices32 = np.ascontiguousarray(indices, dtype=np.int32)
    if int(indptr64[-1]) != len(indices32):
        raise ValueError(f"indptr ends at {int(indptr64[-1])}, indices has {len(indices32)}")
    if len(indices32) and (int(indices32.min()) < 0 or int(indices32.max()) >= n):
        raise ValueError(f"indices outside [0, {n})")
    labels = (np.arange(n, dtype=np.int64) if seed_labels is None
              else np.array(seed_labels, dtype=np.int64))
    if len(labels) != n:
        raise ValueError(f"{len(labels)} seed labels for {n} nodes")
    rc = lib.gcn_lpa(indptr64.ctypes.data_as(_i64p), indices32.ctypes.data_as(_i32p),
                     n, rounds, labels.ctypes.data_as(_i64p))
    if rc < 0:
        raise RuntimeError(f"native LPA failed (rc={rc})")
    return labels
