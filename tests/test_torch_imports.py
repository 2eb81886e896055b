"""Guards of the port: no JAX anywhere in it, no silent CPU fallback.

The import check runs in a subprocess because tests/conftest.py imports jax.
"""

import os
import subprocess
import sys

import pytest
import torch

from cuda_gcn_torch import kernels, train
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import graph as tgraph
from cuda_gcn_torch.device import resolve_device
from cuda_gcn_torch.ops import bsr as tbsr
from cuda_gcn_torch.ops import residual as tres

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import cuda_gcn_torch
for m in pkgutil.walk_packages(cuda_gcn_torch.__path__, "cuda_gcn_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "cuda_gcn_tpu"))
print(len([m for m in sys.modules if m.startswith("cuda_gcn_torch")]), bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15  # every module was imported


@pytest.mark.parametrize("entry", ["resolve_device", "build_graph", "create_state",
                                   "run"])
def test_entry_points_default_to_cuda_and_raise_without_it(tiny_dataset, entry,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "build_graph": lambda: tgraph.build_graph(
            __import__("cuda_gcn_torch.data.dataset", fromlist=["CSR"]).CSR(
                tiny_dataset.graph.indptr, tiny_dataset.graph.indices)),
        "create_state": lambda: train.create_state(GCNConfig()),
        "run": lambda: train.run(GCNConfig(epochs=1, reorder="none"), tiny_dataset),
    }
    with pytest.raises(RuntimeError, match="CUDA device"):
        calls[entry]()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _forbid_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a non-CPU tensor reached the plain version")

    monkeypatch.setattr(tbsr, "bsr_tile_contract_plain", plain)
    monkeypatch.setattr(tres, "residual_spmm_plain", plain)


def test_device_tensors_go_to_the_launchers(monkeypatch):
    """A tensor off the CPU never reaches the plain version: it goes to the
    launcher (monkeypatched here, there being no card) ..."""
    _forbid_plain(monkeypatch)
    seen = []
    monkeypatch.setattr(kernels, "bsr_tile", lambda *a, **k: seen.append("bsr_tile"))
    monkeypatch.setattr(kernels, "csr_spmm", lambda *a, **k: seen.append("csr_spmm"))
    plan = tbsr.TilePlan(_meta(3, dtype=torch.int32), _meta(4, dtype=torch.int32),
                         _meta(4, dtype=torch.int32))
    tbsr.bsr_tile_contract(_meta(4, 32, 32, dtype=torch.bfloat16),
                           _meta(4, dtype=torch.int32), _meta(4, dtype=torch.int32),
                           _meta(60, 16), 60, 2, plan=plan)
    tres.residual_spmm(_meta(61, dtype=torch.int32), _meta(9, dtype=torch.int32),
                       _meta(9), _meta(60, 16))
    assert seen == ["bsr_tile", "csr_spmm"]


def test_device_tensors_raise_in_the_real_launchers(monkeypatch):
    """... and the real launchers raise for what is not a CUDA tensor, without
    building anything or counting a launch."""
    _forbid_plain(monkeypatch)
    kernels.reset_launches()
    plan = tbsr.TilePlan(_meta(3, dtype=torch.int32), _meta(4, dtype=torch.int32),
                         _meta(4, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tbsr.bsr_tile_contract(_meta(4, 32, 32, dtype=torch.bfloat16),
                               _meta(4, dtype=torch.int32), _meta(4, dtype=torch.int32),
                               _meta(60, 16), 60, 2, plan=plan)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        tres.residual_spmm(_meta(61, dtype=torch.int32), _meta(9, dtype=torch.int32),
                           _meta(9), _meta(60, 16))
    assert kernels.launches == {"bsr_tile": 0, "csr_spmm": 0}


def test_kernel_build_sources_and_flags():
    """Both kernels build from the package's own sources for sm_90a."""
    for name in kernels.launches:
        assert os.path.exists(os.path.join(kernels.SRC_DIR, f"{name}.cu"))
        path = kernels._lib_path(name)
        assert path.startswith(os.path.join(ROOT, "build", "kernels"))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
