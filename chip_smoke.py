"""Drive the PyTorch port (cuda_gcn_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code not 0) when it fails:

(a) build both CUDA kernels from cuda_gcn_torch/csrc with nvcc for sm_90a;
(b) load synth-reddit with its cached locality permutation, build its graph on
    the card, and hold each kernel against its plain PyTorch version at the
    main path's widths 16, 32, 41, 82 (kernel 1 in both orientations);
(c) the main path: ``train.run`` trains the 602-16-41 GCN on the bsr backend
    with dropout 0.5; losses must be finite, the train loss must fall, and
    each kernel must have launched on every adjacency pass (4 per epoch, 2
    for the trailing eval, 2 for the test eval);
(d) time each kernel, its plain version and one PyTorch library call for the
    same function at the main path's shapes, beside the least time the card
    could take (its bound);
(e) train synth-pubmed on the card and on the CPU (plain versions) from the
    same weights at dropout 0: the metrics must agree;
(f) device time by kernel and the device's busy share, from torch.profiler
    over a few warm epochs (run before (e)).

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1
and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s, and
# f32 FLOP/s outside the tensor cores, the rate both kernels' f32 FMAs run at.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
EPOCHS = 10               # main-path epochs
WIDTHS = (16, 32, 41, 82)  # pass widths of the main path: pair 32/82, backward 16/41
ATOL, RTOL = 1e-5, 1e-4    # f32; only the summation order differs from the plain version


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_errors(got, want):
    """(max abs error, max of |err| / (atol + rtol·|want|)): the check passes
    when the second is at most 1."""
    err = (got - want).abs()
    return float(err.max()), float((err / (ATOL + RTOL * want.abs())).max())


def check(name: str, got, want) -> float:
    abs_err, ratio = max_errors(got, want)
    ok = ratio <= 1.0
    log(f"  {name}: max_abs_err={abs_err:.3e} max_err/tol={ratio:.3f} "
        f"(atol {ATOL}, rtol {RTOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return abs_err


def phase_build():
    from cuda_gcn_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build()
    log(f"(a) built {sorted(report) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s with {' '.join(kernels.NVCC_FLAGS)}")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(dataset, device):
    import torch

    from cuda_gcn_torch.data.graph import build_graph
    from cuda_gcn_torch.ops.bsr import (bsr_tile_contract, bsr_tile_contract_plain,
                                        tile_plan)
    from cuda_gcn_torch.ops.residual import residual_spmm, residual_spmm_plain

    t0 = time.perf_counter()
    graph = build_graph(dataset.graph, backend="bsr", device=device)
    torch.cuda.synchronize()
    covered = graph.total_nnz - graph.resid_nnz
    log(f"(b) graph built in {time.perf_counter() - t0:.1f} s: n={graph.n_nodes} "
        f"nnz={graph.total_nnz} K={graph.num_tiles} T={graph.t_blocks} "
        f"tb={graph.tb} residual nnz={graph.resid_nnz} "
        f"tile coverage={covered / graph.total_nnz:.4f} symmetric={graph.symmetric}")
    deg = torch.diff(graph.resid.row_ptr.long()).float()
    per_row = torch.diff(graph.plan.ptr.long()).float()
    log(f"  residual edges per row: mean {deg.mean():.2f} p99 "
        f"{deg.quantile(0.99):.0f} max {deg.max():.0f}; tiles per block row: mean "
        f"{per_row.mean():.2f} p99 {per_row.quantile(0.99):.0f} max {per_row.max():.0f}")
    plan_t = tile_plan(graph.tile_cols, graph.tile_rows, graph.t_blocks)
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {"bsr_tile": 0.0, "csr_spmm": 0.0}
    r = graph.resid
    for d in WIDTHS:
        h = torch.randn(graph.n_nodes, d, generator=gen, device=device)
        for transpose in (False, True):
            rows, cols, plan = ((graph.tile_cols, graph.tile_rows, plan_t) if transpose
                                else (graph.tile_rows, graph.tile_cols, graph.plan))
            got = bsr_tile_contract(graph.tiles, rows, cols, h, graph.n_nodes,
                                    graph.t_blocks, transpose=transpose, plan=plan)
            want = bsr_tile_contract_plain(graph.tiles, rows, cols, h, graph.n_nodes,
                                           graph.t_blocks, transpose=transpose)
            errs["bsr_tile"] = max(errs["bsr_tile"], check(
                f"bsr_tile d={d} transpose={transpose}", got, want))
        got = residual_spmm(r.row_ptr, r.cols, r.coef, h)
        want = residual_spmm_plain(r.row_ptr, r.cols, r.coef, h)
        errs["csr_spmm"] = max(errs["csr_spmm"], check(f"csr_spmm d={d}", got, want))
        base = torch.randn(graph.n_nodes, d, generator=gen, device=device)
        got = residual_spmm(r.row_ptr, r.cols, r.coef, h, out=base.clone())
        want = residual_spmm_plain(r.row_ptr, r.cols, r.coef, h, out=base.clone())
        errs["csr_spmm"] = max(errs["csr_spmm"], check(
            f"csr_spmm d={d} accumulate", got, want))
    torch.cuda.synchronize()
    return graph, errs


def phase_main_path(dataset):
    import math

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig

    cfg = GCNConfig(epochs=EPOCHS, graphsum_backend="bsr", reorder="none", seed=0)
    log(f"(c) main path: train.run synth-reddit {dataset.input_dim}-{cfg.hidden_dim}-"
        f"{dataset.output_dim}, bsr, dropout {cfg.dropout}, {EPOCHS} epochs")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = train.run(cfg, dataset, device="cuda", verbose=True)
    launches = dict(kernels.launches)
    log(f"  run (graph build included) took {time.perf_counter() - t0:.1f} s; "
        f"fused loop {res.total_train_time * 1e3 / EPOCHS:.2f} ms/epoch "
        f"(first call, warm-up included)")
    losses = [h["train_loss"] for h in res.history]
    if not all(math.isfinite(v) for h in res.history for v in h.values()) \
            or not math.isfinite(res.test_loss):
        raise AssertionError("non-finite metrics on the main path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    expected = 4 * EPOCHS + 2 + 2
    log(f"  launches {launches}; expected {expected} each "
        f"(4 per epoch + 2 trailing eval + 2 test eval)")
    if any(v != expected for v in launches.values()):
        raise AssertionError("a kernel did not run on every adjacency pass")
    return launches


def _fused_inputs(dataset):
    """Features, truths and step arguments of the main path, for timing
    ``train.run_epochs`` on an already built graph."""
    import numpy as np
    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig

    cfg = dataset.apply_config(GCNConfig(seed=0))
    x = torch.from_numpy(dataset.dense_features(np.float32)).cuda()
    truths = [train.make_truth(dataset.split, dataset.label, s, "cuda") for s in (1, 2)]
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay,
              lr=cfg.learning_rate)
    return cfg, x, truths, kw


def phase_steady(graph, dataset) -> float:
    import torch

    from cuda_gcn_torch import train

    cfg, x, truths, kw = _fused_inputs(dataset)
    train.run_epochs(train.create_state(cfg, "cuda"), graph, x, *truths, epochs=2, **kw)
    state = train.create_state(cfg, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.run_epochs(state, graph, x, *truths, epochs=EPOCHS, **kw).cpu()
    ms = (time.perf_counter() - t0) * 1e3 / EPOCHS
    log(f"  steady fused loop: {ms:.2f} ms/epoch over {EPOCHS} epochs "
        f"(incl. the trailing eval)")
    return ms


def phase_profile(graph, dataset, epochs: int = 3):
    """torch.profiler over a few warm fused epochs: device time by kernel and
    the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuda_gcn_torch import train

    cfg, x, truths, kw = _fused_inputs(dataset)
    state = train.create_state(cfg, "cuda")
    train.run_epochs(state, graph, x, *truths, epochs=2, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.run_epochs(state, graph, x, *truths, epochs=epochs, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ms = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0 and getattr(evt, "device_type", None) is not None \
                and "CUDA" in str(evt.device_type):
            kernels_ms[evt.key] = kernels_ms.get(evt.key, 0.0) + dev_us / 1e3
    busy = sum(kernels_ms.values())
    log(f"(f) profile of {epochs} warm fused epochs: wall {wall_ms / epochs:.2f} ms/epoch, "
        f"device busy {busy / epochs:.2f} ms/epoch ({busy / wall_ms:.3f} of wall)")
    for name, ms in sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {ms / epochs:9.3f} ms/epoch  {name[:110]}")


def _library_ms(make, iters):
    """Time one PyTorch library call (a yardstick only; the port never calls
    it). Returns (ms or None, note)."""
    import torch

    try:
        fn = make()
        return cuda_ms(fn, iters), ""
    except (RuntimeError, NotImplementedError, TypeError) as e:
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def phase_timing(graph, launches, errs):
    import torch

    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, bsr_tile_contract_plain
    from cuda_gcn_torch.ops.residual import residual_spmm, residual_spmm_plain

    n, k, tb, t_blocks = graph.n_nodes, graph.num_tiles, graph.tb, graph.t_blocks
    r = graph.resid
    m = r.nnz
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows_out = []
    log("(d) timing at the main path's shapes (CUDA events, warm, mean of iters)")
    for d in WIDTHS:
        h = torch.randn(n, d, generator=gen, device="cuda")
        t1 = cuda_ms(lambda: bsr_tile_contract(graph.tiles, graph.tile_rows, graph.tile_cols,
                                               h, n, t_blocks, plan=graph.plan), 10)
        p1 = cuda_ms(lambda: bsr_tile_contract_plain(graph.tiles, graph.tile_rows,
                                                     graph.tile_cols, h, n, t_blocks), 3)
        out = torch.zeros(n, d, device="cuda")
        t2 = cuda_ms(lambda: residual_spmm(r.row_ptr, r.cols, r.coef, h, out=out), 10)
        p2 = cuda_ms(lambda: residual_spmm_plain(r.row_ptr, r.cols, r.coef, h, out=out), 5)
        log(f"  d={d}: bsr_tile {t1:.3f} ms (plain {p1:.3f}); "
            f"csr_spmm {t2:.3f} ms (plain {p2:.3f})")
        rows_out.append((d, t1, p1, t2, p2))
    d = WIDTHS[-1]
    _, t1, p1, t2, p2 = rows_out[-1]
    h = torch.randn(n, d, generator=gen, device="cuda")

    def bsr_lib():
        a = torch.sparse_bsr_tensor(graph.plan.ptr.long(), graph.tile_cols.long(),
                                    graph.tiles.float(), size=(t_blocks * tb, t_blocks * tb))
        hp = torch.zeros(t_blocks * tb, d, device="cuda")
        hp[:n] = h
        return lambda: a @ hp

    def csr_lib():
        a = torch.sparse_csr_tensor(r.row_ptr.long(), r.cols.long(), r.coef, size=(n, n))
        return lambda: a @ h

    l1, note1 = _library_ms(bsr_lib, 3)
    l2, note2 = _library_ms(csr_lib, 10)
    log(f"  library at d={d}: sparse BSR @ dense "
        f"{'%.3f ms' % l1 if l1 is not None else 'did not run (' + note1 + ')'}; "
        f"sparse CSR @ dense "
        f"{'%.3f ms' % l2 if l2 is not None else 'did not run (' + note2 + ')'}")
    # bounds: each input read once, each output written once; f32 FMAs = 2 flops
    tile_bytes = graph.tiles.numel() * graph.tiles.element_size()
    b1_bytes = tile_bytes + 4 * (2 * k + t_blocks + 1) + 4 * n * d + 4 * n * d
    b1_ops = 2 * k * tb * tb * d
    b2_bytes = 8 * m + 4 * (n + 1) + 4 * n * d + 2 * 4 * n * d  # h, out read + written
    b2_ops = 2 * m * d
    kernels_line = []
    for name, src, replaces, ms, plain, lib, bbytes, ops in (
            ("bsr_tile", "cuda_gcn_torch/csrc/bsr_tile.cu",
             "cuda_gcn_tpu/ops/pallas_bsr.py:65 (+ :120 _bsr_kernel_resident)",
             t1, p1, l1, b1_bytes, b1_ops),
            ("csr_spmm", "cuda_gcn_torch/csrc/csr_spmm.cu",
             "cuda_gcn_tpu/ops/graphsum.py:136 (XLA _blocked2d_apply, not Pallas)",
             t2, p2, l2, b2_bytes, b2_ops)):
        t_bytes = bbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        kernels_line.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib, "d": d,
            "ms_by_width": {str(row[0]): row[1] if name == "bsr_tile" else row[3]
                            for row in rows_out},
            "plain_ms_by_width": {str(row[0]): row[2] if name == "bsr_tile" else row[4]
                                  for row in rows_out}})
        log(f"  {name} d={d}: {ms:.3f} ms, bound {max(t_bytes, t_ops):.3f} ms "
            f"(bytes {t_bytes:.3f}, operations {t_ops:.3f})")
    return kernels_line


def phase_small_reference():
    """synth-pubmed, 3 epochs at dropout 0 from the same weights: the card
    (kernels) against the CPU (plain versions)."""
    import numpy as np

    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached, reorder_cached

    ds = reorder_cached(load_cached("synth-pubmed"), "synth-pubmed")
    cfg = GCNConfig(epochs=3, dropout=0.0, graphsum_backend="bsr", reorder="none")
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = train.run(cfg, ds, device=dev, verbose=False)
    a = np.array([[h[k] for k in ("train_loss", "train_acc", "val_loss", "val_acc")]
                  for h in out["cuda"].history] + [[out["cuda"].test_loss,
                                                    out["cuda"].test_acc, 0, 0]])
    b = np.array([[h[k] for k in ("train_loss", "train_acc", "val_loss", "val_acc")]
                  for h in out["cpu"].history] + [[out["cpu"].test_loss,
                                                   out["cpu"].test_acc, 0, 0]])
    diff = float(np.abs(a - b).max())
    log(f"(e) synth-pubmed 3 epochs, card vs CPU plain versions: max metric diff "
        f"{diff:.3e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU disagree on synth-pubmed:\n{a}\n{b}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from cuda_gcn_torch.data.dataset import load_cached, reorder_cached
    from cuda_gcn_torch.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_all = time.perf_counter()
    phase_build()
    t0 = time.perf_counter()
    dataset = reorder_cached(load_cached("synth-reddit"), "synth-reddit")
    log(f"loaded and reordered synth-reddit in {time.perf_counter() - t0:.1f} s")
    graph, errs = phase_kernels(dataset, device)
    launches = phase_main_path(dataset)
    phase_steady(graph, dataset)
    kernels_line = phase_timing(graph, launches, errs)
    phase_profile(graph, dataset)
    del graph
    torch.cuda.empty_cache()
    phase_small_reference()
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
