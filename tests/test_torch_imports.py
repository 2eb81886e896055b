"""Guards of the port: no JAX anywhere in it, no silent CPU fallback.

The import check runs in a subprocess because tests/conftest.py imports jax.
"""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from cuda_gcn_torch import bench as tbench
from cuda_gcn_torch import bench_scaling as tbench_scaling
from cuda_gcn_torch import kernels, train
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data import graph as tgraph
from cuda_gcn_torch.device import resolve_device
from cuda_gcn_torch.ops import bsr as tbsr
from cuda_gcn_torch.ops import ell as tell
from cuda_gcn_torch.ops import graphsum as tgs
from cuda_gcn_torch.ops import matmul as tmm
from cuda_gcn_torch.ops import residual as tres
from cuda_gcn_torch.parallel import multihost, sharded
from cuda_gcn_torch.probes import dyngather as tdyn
from cuda_gcn_torch.probes import gather as tprobe
from cuda_gcn_torch.probes import taa as ttaa

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
    assert int(res.stdout.split()[0]) >= 37  # every module was imported


def test_the_synthetic_generator_and_the_cli_import_no_jax():
    """The port's copy of the generator and the CLI that calls it stand alone:
    importing them pulls in neither jax, ml_dtypes nor the JAX package."""
    code = ("import sys; import cuda_gcn_torch.data.synthetic, cuda_gcn_torch.cli, "
            "cuda_gcn_torch.convert; bad = sorted(m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'ml_dtypes', 'cuda_gcn_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", ["timer", "logging", "checkpoint", "profiling"])
def test_the_utilities_import_no_jax(module):
    """Each utility of the port stands alone, the checkpoint reader (which
    reads the JAX package's bf16 records) included: importing it pulls in
    neither jax, ml_dtypes nor the JAX package."""
    code = (f"import sys; import cuda_gcn_torch.utils.{module}; bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'cuda_gcn_tpu')); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", ["partition", "multihost", "sharded"])
def test_the_sharded_trainer_imports_no_jax(module):
    """Each module of cuda_gcn_torch.parallel stands alone: importing it pulls
    in neither jax, ml_dtypes nor the JAX package."""
    code = (f"import sys; import cuda_gcn_torch.parallel.{module}; bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'cuda_gcn_tpu')); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", ["native", "native_build", "reddit"])
def test_the_native_host_code_and_the_converter_import_no_jax(module):
    """The native host code's bindings and the GraphSAGE converter stand alone:
    importing one pulls in neither jax, ml_dtypes nor the JAX package, and
    builds nothing."""
    code = (f"import os, sys; import cuda_gcn_torch.data.{module}; "
            "from cuda_gcn_torch.data import native; bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'cuda_gcn_tpu')); print(bad, native._libs); "
            "sys.exit(1 if bad or native._libs else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("module", ["bench", "bench_scaling"])
def test_the_benchmark_entries_import_no_jax(module):
    """``python -m cuda_gcn_torch.bench`` and ``.bench_scaling`` stand alone:
    importing one pulls in neither jax, ml_dtypes nor the JAX package (not
    even the root bench.py, which shares the module name)."""
    code = (f"import sys; import cuda_gcn_torch.{module}; bad = sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', "
            "'cuda_gcn_tpu', 'bench')); print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _one_shard(ds):
    cfg, shards, _ = sharded.prepare_sharded(GCNConfig(reorder="none"), ds, 1)
    return cfg, shards[0]


@pytest.mark.parametrize("entry", ["resolve_device", "build_graph", "create_state",
                                   "run", "run_sharded", "initialize", "bench",
                                   "bench_scaling"])
def test_entry_points_default_to_cuda_and_raise_without_it(tiny_dataset, entry,
                                                           monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "build_graph": lambda: tgraph.build_graph(
            __import__("cuda_gcn_torch.data.dataset", fromlist=["CSR"]).CSR(
                tiny_dataset.graph.indptr, tiny_dataset.graph.indices)),
        "create_state": lambda: train.create_state(GCNConfig()),
        "run": lambda: train.run(GCNConfig(epochs=1, reorder="none"), tiny_dataset),
        # the sharded trainer: a rank's run, and its process group (NCCL by default)
        "run_sharded": lambda: sharded.run_sharded(*_one_shard(tiny_dataset)),
        "initialize": lambda: multihost.initialize(f"file://{tmp_path}/store", 1, 0),
        # the benchmark entries, before they read a dataset
        "bench": lambda: tbench.run_bench(tbench.build_argparser().parse_args([])),
        "bench_scaling": lambda: tbench_scaling.main(["--stats-only"]),
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
    monkeypatch.setattr(tell, "ell_spmm_plain", plain)
    monkeypatch.setattr(tprobe, "gather_probe_plain", plain)
    monkeypatch.setattr(tprobe, "scatter_probe_plain", plain)
    monkeypatch.setattr(tmm, "csr_matmul_plain", plain)
    for name in ("taa_rows_plain", "taa_lanes_plain", "cumsum_probe_plain",
                 "piece_probe_plain"):
        monkeypatch.setattr(ttaa, name, plain)


def _meta_ell_plan(n):
    i32 = dict(dtype=torch.int32)
    return tell.EllPlan(n_nodes=n, nnz=3 * n, cols=_meta(8 * n, **i32), coef=_meta(8 * n),
                        rows=_meta(n, **i32), offsets=(0, 8 * n), row_starts=(0, n),
                        widths=(8,), work_beg=_meta(n, **i32), work_len=_meta(n, **i32),
                        work_dst=_meta(n, **i32), split_rows=_meta(0, **i32),
                        split_ptr=_meta(1, **i32), n_partials=0)


def _meta_work(rows):
    i32 = dict(dtype=torch.int32)
    return tell.WorkList(beg=_meta(rows, **i32), len=_meta(rows, **i32),
                         dst=_meta(rows, **i32), split_rows=_meta(0, **i32),
                         split_ptr=_meta(1, **i32), n_partials=0, n_nonempty=rows)


def _meta_features(n, f, nnz):
    i32 = dict(dtype=torch.int32)
    return tmm.SparseFeatures(
        values=_meta(nnz), rows=_meta(nnz, **i32), cols=_meta(nnz, **i32), n_rows=n, n_cols=f,
        row_ptr=_meta(n + 1, **i32), t_ptr=_meta(f + 1, **i32), t_rows=_meta(nnz, **i32),
        t_perm=_meta(nnz, dtype=torch.int64), t_work=_meta_work(f), work=_meta_work(n))


def _wrapper_calls():
    """(launcher name, a call of its wrapper on meta tensors), for each kernel
    and, after them, for the sparse layer-0 product's two uses of kernels 2 and 3."""
    i32 = dict(dtype=torch.int32)
    plan = tbsr.TilePlan(_meta(3, **i32), _meta(4, **i32), _meta(4, **i32))
    feats = _meta_features(60, 12, 90)
    s, l = 64, 128
    piece_args = (_meta(s, 1, **i32), _meta(s, 1), _meta(s, 1, **i32), _meta(s, 1, **i32))
    return [
        ("bsr_tile", lambda: tbsr.bsr_tile_contract(
            _meta(4, 32, 32, dtype=torch.bfloat16), _meta(4, **i32), _meta(4, **i32),
            _meta(60, 16), 60, 2, plan=plan)),
        ("csr_spmm", lambda: tres.residual_spmm(_meta(61, **i32), _meta(9, **i32),
                                                _meta(9), _meta(60, 16),
                                                work=_meta_work(60))),
        ("ell_spmm", lambda: tell.ell_spmm(_meta_ell_plan(60), _meta(60, 16))),
        ("gather_probe", lambda: tprobe.gather_probe(_meta(4096, **i32), _meta(64, 128))),
        ("scatter_probe", lambda: tprobe.scatter_probe(_meta(4096, **i32), _meta(4096),
                                                       _meta(64, 128), 1000)),
        ("taa_rows", lambda: ttaa.taa_probe(_meta(s, 1, **i32), _meta(s, l), 2)),
        ("taa_lanes", lambda: tdyn.lane_gather(_meta(3, l, **i32),
                                               _meta(s, l, dtype=torch.bfloat16))),
        ("cumsum_cols", lambda: ttaa.cumsum_probe(_meta(s, l), 2)),
        ("piece", lambda: ttaa.piece_probe(*piece_args, _meta(s, l), 2)),
        ("taa_rows", lambda: tdyn.sublane_gather(_meta(s, 4, **i32), _meta(s, l))),
        ("csr_spmm", lambda: tmm.csr_matmul(feats.values, feats, _meta(12, 16))),
        ("ell_spmm", lambda: tmm.csr_matmul_dw(feats, feats.values, _meta(60, 16))),
    ]


def test_device_tensors_go_to_the_launchers(monkeypatch):
    """A tensor off the CPU never reaches the plain version: it goes to the
    launcher (monkeypatched here, there being no card) ..."""
    _forbid_plain(monkeypatch)
    seen = []
    calls = _wrapper_calls()
    for name, _ in calls:
        monkeypatch.setattr(kernels, name, lambda *a, _n=name, **k: seen.append(_n))
    for _, call in calls:
        call()
    assert seen == [name for name, _ in calls]
    assert seen[:len(kernels.launches)] == list(kernels.launches)


@pytest.mark.parametrize("backend", ["ell", "pallas"])
def test_ell_backends_launch_kernel_3_at_any_size(monkeypatch, backend):
    """On a CUDA (here meta) tensor, graphsum on the ell and pallas backends
    reaches the ell_spmm launcher however large the graph: the JAX package's
    VMEM fallback is not carried over."""
    _forbid_plain(monkeypatch)
    seen = []
    monkeypatch.setattr(kernels, "ell_spmm", lambda *a, **k: seen.append(a[-2]))
    n = 10**7
    graph = tgraph.Graph(n_nodes=n, backend=backend, symmetric=True, total_nnz=3 * n,
                         ell=_meta_ell_plan(n))
    tgs.forward(_meta(n, 128), graph)
    tgs.transpose_forward(_meta(n, 41), graph)
    assert seen == [n, n]


def test_device_tensors_raise_in_the_real_launchers(monkeypatch):
    """... and the real launchers raise for what is not a CUDA tensor, without
    building anything or counting a launch."""
    _forbid_plain(monkeypatch)
    kernels.reset_launches()
    for _, call in _wrapper_calls():
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            call()
    assert all(v == 0 for v in kernels.launches.values())


def _cpu_work(rows):
    z = torch.zeros(rows, dtype=torch.int32)
    return tell.WorkList(beg=z, len=z, dst=z, split_rows=z[:0], split_ptr=z[:1],
                         n_partials=0, n_nonempty=rows)


@pytest.mark.parametrize("case", ["bsr_tile-bf16-64", "bsr_tile-bf16-32", "bsr_tile-f32",
                                  "csr_spmm", "csr_spmm-accumulate"])
def test_redesigned_launchers_raise_on_cpu_tensors(case):
    """Kernels 1 and 2 have no path for a CPU tensor, whichever of kernel 1's
    two device kernels the call would take: the launcher raises before it
    builds, allocates or counts anything."""
    i32 = torch.int32
    kernels.reset_launches()
    if case.startswith("bsr_tile"):
        tb = 64 if case.endswith("64") else 32
        dtype = torch.float32 if case.endswith("f32") else torch.bfloat16
        k, t_blocks, n = 3, 2, 2 * tb - 5
        call = lambda: kernels.bsr_tile(  # noqa: E731
            torch.zeros(k, tb, tb, dtype=dtype), torch.tensor([0, 2, 3], dtype=i32),
            torch.arange(k, dtype=i32), torch.zeros(k, dtype=i32), torch.zeros(n, 16), n,
            t_blocks, False, row_order=torch.arange(t_blocks, dtype=i32))
    else:
        out = torch.zeros(60, 16) if case.endswith("accumulate") else None
        call = lambda: kernels.csr_spmm(  # noqa: E731
            _cpu_work(60), torch.zeros(9, dtype=i32), torch.zeros(9), torch.zeros(60, 16), 60,
            out)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        call()
    assert all(v == 0 for v in kernels.launches.values())


def test_residual_spmm_needs_its_work_list_off_the_cpu(monkeypatch):
    """Off the CPU the residual product does not rebuild the work list from
    ``row_ptr`` on every call (a device-to-host copy): it raises when the
    caller has none, before it reaches the launcher."""
    _forbid_plain(monkeypatch)
    monkeypatch.setattr(kernels, "csr_spmm", lambda *a, **k: pytest.fail("launched"))
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="work list"):
        tres.residual_spmm(_meta(61, **i32), _meta(9, **i32), _meta(9), _meta(60, 16))


@pytest.mark.parametrize("dtype,tb,k,d,width", [
    (torch.bfloat16, 256, 9, 16, 16), (torch.bfloat16, 256, 9, 17, 32),
    (torch.bfloat16, 256, 9, 41, 48), (torch.bfloat16, 128, 9, 64, 88),
    (torch.bfloat16, 64, 9, 82, 88), (torch.bfloat16, 256, 9, 88, 88),
    (torch.bfloat16, 256, 9, 89, None), (torch.bfloat16, 32, 9, 16, None),
    (torch.bfloat16, 96, 9, 16, None), (torch.bfloat16, 256, 0, 16, None),
    (torch.float32, 256, 9, 16, None)])
def test_kernel_1_is_chosen_by_dtype_tile_size_and_width(dtype, tb, k, d, width):
    """bf16 tiles whose size is a multiple of 64 go to the tensor-core kernel at
    the next accumulator width; f32 tiles, other tile sizes, more than 88
    features and a call without tiles go to the FMA kernel."""
    assert kernels.bsr_mma_width(dtype, tb, k, d) == width


def test_an_edited_header_changes_the_library_path(tmp_path, monkeypatch):
    """A library's name hashes its source and the csrc headers it includes: an
    edit to the shared SpMM header rebuilds kernels 2 and 3 and nothing else."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels.SRC_DIR, src)
    monkeypatch.setattr(kernels, "SRC_DIR", str(src))
    assert kernels._source_files("csr_spmm") == ["csr_spmm.cu", "spmm_common.cuh"]
    assert kernels._source_files("ell_spmm") == ["ell_spmm.cu", "spmm_common.cuh"]
    assert kernels._source_files("bsr_tile") == ["bsr_tile.cu", "hopper_ptx.cuh"]
    assert kernels._source_files("taa_probe") == ["taa_probe.cu"]
    assert kernels._source_files("gather_probe") == ["gather_probe.cu"]
    before = {name: kernels._lib_path(name) for name in kernels.SOURCES}
    with open(src / "spmm_common.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: kernels._lib_path(name) for name in kernels.SOURCES}
    changed = {name for name in kernels.SOURCES if before[name] != after[name]}
    assert changed == {"csr_spmm", "ell_spmm"}
    with open(src / "bsr_tile.cu", "a") as f:
        f.write("// edited\n")
    assert kernels._lib_path("bsr_tile") != after["bsr_tile"]
    assert kernels._lib_path("csr_spmm") == after["csr_spmm"]


def test_kernel_build_sources_and_flags():
    """Every kernel builds from the package's own sources for sm_90a."""
    for name, (source, fn_name, _) in kernels._ENTRY.items():
        assert name in kernels.launches and source in kernels.SOURCES
        with open(os.path.join(kernels.SRC_DIR, f"{source}.cu")) as f:
            assert f'extern "C" int {fn_name}(' in f.read()
    assert "taa_probe" in kernels.SOURCES
    # kernels 2 and 3 are one body in the shared header, each under its own kernel
    for source in ("csr_spmm", "ell_spmm"):
        with open(os.path.join(kernels.SRC_DIR, f"{source}.cu")) as f:
            text = f.read()
        assert "spmm::run_item<" in text and f"{source}_kernel" in text
    assert {n for n, e in kernels._ENTRY.items() if e[0] == "taa_probe"} == {
        "taa_rows", "taa_lanes", "cumsum_cols", "piece"}
    for source in kernels.SOURCES:
        path = kernels._lib_path(source)
        assert path.startswith(os.path.join(ROOT, "build", "kernels"))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
