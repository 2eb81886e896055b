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
    over a few warm epochs (run before (e));
(g) the pallas path: synth-pubmed, 500-16-3, backend ``pallas``. Kernel 3
    (ELL SpMM) against its plain version at d 3, 6, 16, 32, and bitwise equal
    to itself across two runs; ``train.run`` 100 epochs at dropout 0.5 with
    finite metrics, a falling train loss, and kernel 3 launched on every
    adjacency pass (4 per epoch + 2 + 2) and no other kernel; card against
    CPU for 3 epochs at dropout 0 within 1e-4; an early-stopping run that
    stops at the same epoch on the card as on the CPU;
(h) kernel 3 at reddit scale: synth-reddit without reordering, backend
    ``ell``, against its plain version at d 16, 32, 41, 82, timed beside its
    plain version, a sparse CSR product and its bound; ``train.run`` 3 epochs
    with 4 launches per epoch + 4;
(i) the probe kernels (``python -m cuda_gcn_torch.probes.gather``) at the
    script's default shapes: each against its plain version, its time, ns per
    row and bound, and a PyTorch call as the yardstick.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
with all five kernels, and last ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits 1 and prints no result.
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
    from cuda_gcn_torch.device import cuda_ms as timed

    return timed(fn, iters)


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


def _metrics(res):
    """A run's metric rows and, last, its test loss and accuracy."""
    import numpy as np

    return np.array([[h[k] for k in ("train_loss", "train_acc", "val_loss", "val_acc")]
                     for h in res.history] + [[res.test_loss, res.test_acc, 0, 0]])


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
    log(f"  launches {launches}; expected {expected} each for bsr_tile and csr_spmm "
        f"(4 per epoch + 2 trailing eval + 2 test eval), 0 for the others")
    if any(v != (expected if k in ("bsr_tile", "csr_spmm") else 0)
           for k, v in launches.items()):
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


def phase_steady(graph, dataset, label: str = "") -> float:
    import torch

    from cuda_gcn_torch import train

    cfg, x, truths, kw = _fused_inputs(dataset)
    train.run_epochs(train.create_state(cfg, "cuda"), graph, x, *truths, epochs=2, **kw)
    state = train.create_state(cfg, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.run_epochs(state, graph, x, *truths, epochs=EPOCHS, **kw).cpu()
    ms = (time.perf_counter() - t0) * 1e3 / EPOCHS
    log(f"  steady fused loop{label}: {ms:.2f} ms/epoch over {EPOCHS} epochs "
        f"(incl. the trailing eval)")
    return ms


def phase_profile(graph, dataset, epochs: int = 3, label: str = "(f)"):
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
    log(f"{label} profile of {epochs} warm fused epochs: wall {wall_ms / epochs:.2f} "
        f"ms/epoch, device busy {busy / epochs:.2f} ms/epoch ({busy / wall_ms:.3f} of wall)")
    for name, ms in sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8]:
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
    a, b = (_metrics(train.run(cfg, ds, device=dev, verbose=False))
            for dev in ("cuda", "cpu"))
    diff = float(np.abs(a - b).max())
    log(f"(e) synth-pubmed 3 epochs, card vs CPU plain versions: max metric diff "
        f"{diff:.3e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU disagree on synth-pubmed:\n{a}\n{b}")


PUBMED_WIDTHS = (3, 6, 16, 32)  # pass widths of the pubmed path: pair 6/32, backward 3/16
PUBMED_EPOCHS = 100
REDDIT_ELL_EPOCHS = 3


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _ell_bound(plan, d: int) -> tuple[float, str]:
    """Kernel 3's bound: each real slot's index and value, the row ids, h and
    out once (the pad slots are skipped by the kernel), and an FMA per real
    slot and feature."""
    n = plan.n_nodes
    return _bound(8 * plan.nnz + 4 * n + 4 * n * d + 4 * n * d, 2 * plan.nnz * d)


def _check_ell(plan, widths, label, gen, errs, bitwise):
    import torch

    from cuda_gcn_torch.ops.ell import ell_spmm, ell_spmm_plain

    for d in widths:
        h = torch.randn(plan.n_nodes, d, generator=gen, device="cuda")
        got = ell_spmm(plan, h)
        want = ell_spmm_plain(plan, h)
        errs["ell_spmm"] = max(errs["ell_spmm"], check(f"ell_spmm {label} d={d}", got, want))
        if bitwise and not torch.equal(got, ell_spmm(plan, h)):
            raise AssertionError(f"ell_spmm {label} d={d} differs between two runs")


def _time_ell(plan, widths, label, gen, library_csr=None):
    """{d: (ms, plain ms, library ms or None, bound ms, bound_by)}"""
    import torch

    from cuda_gcn_torch.ops.ell import ell_spmm, ell_spmm_plain

    rows = {}
    for d in widths:
        h = torch.randn(plan.n_nodes, d, generator=gen, device="cuda")
        ms = cuda_ms(lambda: ell_spmm(plan, h), 20)
        plain = cuda_ms(lambda: ell_spmm_plain(plan, h), 3)
        lib, note = (None, "not timed") if library_csr is None else _library_ms(
            lambda: (lambda: library_csr @ h), 10)
        bound, by = _ell_bound(plan, d)
        rows[d] = (ms, plain, lib, bound, by)
        log(f"  {label} d={d}: ell_spmm {ms:.4f} ms (plain {plain:.3f}; library "
            f"{'%.4f ms' % lib if lib is not None else note}; bound {bound:.4f} ms, {by})")
    return rows


def phase_pallas_path(errs):
    import math

    import numpy as np
    import torch

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.data.graph import build_graph

    ds = load_cached("synth-pubmed")
    t0 = time.perf_counter()
    graph = build_graph(ds.graph, backend="pallas", device="cuda")
    torch.cuda.synchronize()
    plan = graph.ell
    log(f"(g) pallas path: synth-pubmed graph built in {time.perf_counter() - t0:.2f} s: "
        f"n={plan.n_nodes} nnz={plan.nnz} ELL slots={plan.slots} buckets={len(plan.widths)} "
        f"(widths {plan.widths[0]}..{plan.widths[-1]}) work items={plan.work_beg.numel()} "
        f"chunked rows={plan.split_rows.numel()} symmetric={graph.symmetric}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    _check_ell(plan, PUBMED_WIDTHS, "synth-pubmed", gen, errs, bitwise=True)
    timing = _time_ell(plan, PUBMED_WIDTHS, "synth-pubmed", gen)

    cfg = GCNConfig(epochs=PUBMED_EPOCHS, graphsum_backend="pallas", seed=0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = train.run(cfg, ds, device="cuda", verbose=False)
    launches = dict(kernels.launches)
    log(f"  train.run {ds.input_dim}-{cfg.hidden_dim}-{ds.output_dim} pallas, dropout "
        f"{cfg.dropout}, {PUBMED_EPOCHS} epochs: {time.perf_counter() - t0:.2f} s (graph "
        f"build included), fused loop {res.total_train_time * 1e3 / PUBMED_EPOCHS:.3f} "
        f"ms/epoch; train loss {res.history[0]['train_loss']:.5f} -> "
        f"{res.history[-1]['train_loss']:.5f}, test_acc {res.test_acc:.5f}")
    if not np.isfinite(_metrics(res)).all():
        raise AssertionError("non-finite metrics on the pallas path")
    if not res.history[-1]["train_loss"] < res.history[0]["train_loss"]:
        raise AssertionError("train loss did not fall on the pallas path")
    expected = 4 * PUBMED_EPOCHS + 2 + 2
    log(f"  launches {launches}; expected ell_spmm {expected}, every other kernel 0")
    if launches["ell_spmm"] != expected or any(
            v for k, v in launches.items() if k != "ell_spmm"):
        raise AssertionError("the pallas path did not run every pass through kernel 3")

    phase_steady(graph, ds, " (synth-pubmed, pallas)")
    phase_profile(graph, ds, label="  pallas path,")

    small = GCNConfig(epochs=3, dropout=0.0, graphsum_backend="pallas")
    a, b = (_metrics(train.run(small, ds, device=dev, verbose=False))
            for dev in ("cuda", "cpu"))
    diff = float(np.abs(a - b).max())
    log(f"  card vs CPU plain versions, 3 epochs at dropout 0: max metric diff "
        f"{diff:.3e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU disagree on the pallas path:\n{a}\n{b}")

    es = GCNConfig(epochs=60, dropout=0.0, early_stopping=3, graphsum_backend="pallas")
    stops = {dev: train.run(es, ds, device=dev, verbose=False) for dev in ("cuda", "cpu")}
    vl = [h["val_loss"] for h in stops["cuda"].history]
    w = es.early_stopping
    # val loss minus the mean of the last w (stop when > 0), per epoch from w on
    margin = [vl[i] - sum(vl[i - w + 1:i + 1]) / w for i in range(w - 1, len(vl))]
    log(f"  early stopping (window {w}, dropout 0): card stopped after epoch "
        f"{stops['cuda'].epochs_run}, CPU after {stops['cpu'].epochs_run}; card's stop "
        f"margin {margin[-1]:.3e} at the stop, {max(margin[:-1], default=float('nan')):.3e} "
        f"at the closest earlier epoch")
    if stops["cuda"].epochs_run != stops["cpu"].epochs_run or not \
            stops["cuda"].epochs_run < es.epochs or not math.isfinite(vl[-1]):
        raise AssertionError("early stopping differs between the card and the CPU")
    return launches, timing


def phase_ell_reddit(errs):
    import numpy as np
    import torch

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.data.graph import build_graph, normalization_coefficients

    ds = load_cached("synth-reddit")
    t0 = time.perf_counter()
    graph = build_graph(ds.graph, backend="ell", device="cuda")
    torch.cuda.synchronize()
    plan = graph.ell
    log(f"(h) kernel 3 at reddit scale: synth-reddit (no reordering) ell graph built in "
        f"{time.perf_counter() - t0:.1f} s: n={plan.n_nodes} nnz={plan.nnz} ELL slots="
        f"{plan.slots} buckets={len(plan.widths)} (widths {plan.widths[0]}.."
        f"{plan.widths[-1]}) work items={plan.work_beg.numel()} chunked rows="
        f"{plan.split_rows.numel()} partials={plan.n_partials}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    _check_ell(plan, WIDTHS, "synth-reddit", gen, errs, bitwise=True)
    indptr = ds.graph.indptr.astype(np.int64)
    indices = ds.graph.indices.astype(np.int64)
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr).cuda(), torch.from_numpy(indices).cuda(),
        torch.from_numpy(normalization_coefficients(indptr, indices)).cuda(),
        size=(plan.n_nodes, plan.n_nodes))
    timing = _time_ell(plan, WIDTHS, "synth-reddit", gen, library_csr=csr)
    del csr
    phase_steady(graph, ds, " (synth-reddit, ell)")
    phase_profile(graph, ds, label="  ell backend,")
    del graph, plan
    torch.cuda.empty_cache()

    cfg = GCNConfig(epochs=REDDIT_ELL_EPOCHS, graphsum_backend="ell", seed=0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = train.run(cfg, ds, device="cuda", verbose=False)
    launches = dict(kernels.launches)
    expected = 4 * REDDIT_ELL_EPOCHS + 4
    log(f"  train.run {ds.input_dim}-{cfg.hidden_dim}-{ds.output_dim} ell, "
        f"{REDDIT_ELL_EPOCHS} epochs: {time.perf_counter() - t0:.1f} s (graph build "
        f"included), fused loop {res.total_train_time * 1e3 / REDDIT_ELL_EPOCHS:.2f} "
        f"ms/epoch; launches {launches}, expected ell_spmm {expected}")
    if not np.isfinite(_metrics(res)).all():
        raise AssertionError("non-finite metrics on the reddit ell run")
    if launches["ell_spmm"] != expected:
        raise AssertionError("the reddit ell run did not go through kernel 3")
    return timing


def phase_probes(errs):
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.probes import gather as probes

    kernels.reset_launches()
    res = probes.run()
    launches = dict(kernels.launches)
    x, mb = res["inputs"], res["mb"]
    h, idx, idx_sorted, coef = x["h"], x["idx"], x["idx_sorted"], x["coef"]
    rows, d = h.shape
    m = idx.numel()
    log(f"(i) probes at table [{rows}, {d}], m={m}, mb={mb}: launches {launches}")
    # probe A sums 2^20 terms: the tolerance scales with their magnitudes
    got = probes.gather_probe(idx, h)
    want = probes.gather_probe_plain(idx, h)
    mass = probes.gather_probe_plain(idx, h.abs())
    err = float((got - want).abs().max())
    ratio = float(((got - want).abs() / (1e-6 * mass)).max())
    log(f"  gather_probe: max_abs_err={err:.3e} max_err/tol={ratio:.3f} "
        f"(tol 1e-6 * sum_i |h[idx[i]]|) {'ok' if ratio <= 1 else 'FAIL'}")
    if ratio > 1 or not torch.equal(got, probes.gather_probe(idx, h)):
        raise AssertionError("gather_probe disagrees with its plain version or itself")
    errs["gather_probe"] = err
    got = probes.scatter_probe(idx_sorted, coef, h, mb)
    errs["scatter_probe"] = check("scatter_probe", got,
                                  probes.scatter_probe_plain(idx_sorted, coef, h, mb))
    if not torch.equal(got, probes.scatter_probe(idx_sorted, coef, h, mb)):
        raise AssertionError("scatter_probe differs between two runs")
    plain_a = cuda_ms(lambda: probes.gather_probe_plain(idx, h), 5)
    plain_b = cuda_ms(lambda: probes.scatter_probe_plain(idx_sorted, coef, h, mb), 5)
    lib_a, _ = _library_ms(lambda: (lambda: h.index_select(0, idx).sum(0)), 10)
    ar = torch.arange(mb, device="cuda") % rows

    def scatter_lib():
        src = h.index_select(0, ar) * coef[:mb, None]
        return lambda: torch.zeros(rows, d, device="cuda").index_add_(0, idx_sorted[:mb], src)

    lib_b, _ = _library_ms(scatter_lib, 10)
    bound_a = _bound(4 * m + 4 * rows * d + 4 * d, m * d)
    bound_b = _bound(8 * mb + 4 * min(mb, rows) * d + 4 * rows * d, 2 * mb * d)
    out = {}
    for name, key, plain, lib, (bound, by), count in (
            ("gather_probe", "A", plain_a, lib_a, bound_a, m),
            ("scatter_probe", "B", plain_b, lib_b, bound_b, mb)):
        ms = res[key]["ms"]
        log(f"  {name}: {ms:.4f} ms = {res[key]['ns_per_row']:.4f} ns/row over {count} "
            f"rows (plain {plain:.4f} ms; library "
            f"{'%.4f ms' % lib if lib is not None else 'did not run'}; bound "
            f"{bound:.4f} ms, {by})")
        out[name] = dict(launches=launches[name], ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by, ns_per_row=res[key]["ns_per_row"])
    return out


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
    del dataset
    errs["ell_spmm"] = 0.0
    pallas_launches, pubmed_timing = phase_pallas_path(errs)
    reddit_timing = phase_ell_reddit(errs)
    probe_rows = phase_probes(errs)
    d = WIDTHS[-1]
    ms, plain, lib, bound, by = reddit_timing[d]
    kernels_line.append({
        "name": "ell_spmm", "route": "cuda", "source": "cuda_gcn_torch/csrc/ell_spmm.cu",
        "replaces": "cuda_gcn_tpu/ops/pallas_spmm.py:67 (_ell_kernel)",
        "launches": pallas_launches["ell_spmm"], "max_abs_err": errs["ell_spmm"],
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib,
        "d": d, "graph": "synth-reddit",
        "ms_by_width": {g: {str(w): r[0] for w, r in t.items()}
                        for g, t in (("synth-pubmed", pubmed_timing),
                                     ("synth-reddit", reddit_timing))},
        "plain_ms_by_width": {g: {str(w): r[1] for w, r in t.items()}
                              for g, t in (("synth-pubmed", pubmed_timing),
                                           ("synth-reddit", reddit_timing))},
        "bound_ms_by_width": {g: {str(w): r[3] for w, r in t.items()}
                              for g, t in (("synth-pubmed", pubmed_timing),
                                           ("synth-reddit", reddit_timing))},
        "library_ms_by_width": {"synth-reddit": {str(w): r[2]
                                                 for w, r in reddit_timing.items()}}})
    for name, line in probe_rows.items():
        kernels_line.append({
            "name": name, "route": "cuda", "source": "cuda_gcn_torch/csrc/gather_probe.cu",
            "replaces": "scripts/exp_pallas_gather.py:" + (
                "60 (gather_kernel)" if name == "gather_probe" else "85 (scatter_kernel)"),
            "max_abs_err": errs[name], **line})
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
