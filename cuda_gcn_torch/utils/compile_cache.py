"""Where the port's built libraries live: the counterpart of the JAX package's
persistent XLA cache (cuda_gcn_tpu/utils/compile_cache.py).

What a run of the port compiles and keeps across processes are the nvcc
libraries of its kernels (``kernels.BUILD_DIR``, ``build/kernels`` at the
repository root by default) and the g++ libraries of its host code
(``native.BUILD_DIR``, ``build/native``). Each library's name hashes its
sources and flags, so a directory can serve any number of trees and runs.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from cuda_gcn_torch import kernels
from cuda_gcn_torch.data import native


def use_build_dir(root: str) -> str:
    """Build the kernel libraries into, and load them from, ``root``/kernels,
    and the host libraries from ``root``/native. An empty ``root`` is a fresh
    temporary directory, removed when the process exits. A library already
    loaded by this process stays loaded. Returns the directory."""
    if not root:
        root = tempfile.mkdtemp(prefix="cuda_gcn_torch_build_")
        atexit.register(shutil.rmtree, root, ignore_errors=True)
    root = os.path.abspath(root)
    kernels.BUILD_DIR = os.path.join(root, "kernels")
    native.BUILD_DIR = os.path.join(root, "native")
    return root
