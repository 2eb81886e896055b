"""Drive the PyTorch port (cuda_gcn_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code not 0) when it fails:

(a) build every CUDA source of cuda_gcn_torch/csrc with nvcc for sm_90a (one
    nvcc per source, started together);
(b) load synth-reddit with its cached locality permutation, build its graph on
    the card, and hold each kernel against its plain PyTorch version at the
    main path's widths 16, 32, 41, 82 (kernel 1, bf16x3 on the tensor cores, in
    both orientations; kernel 2 with and without accumulate), each also run
    twice and compared bitwise; then kernel 1's other cases on synth-pubmed:
    f32 tiles (the FMA kernel), tile sizes 64 and 128, the widths 60 and 100
    that the main path does not reach (100 falls to the FMA kernel), each with
    f32 and with bf16 h, and a case built so that every output needs the third
    bf16 part of h; and on block rows of 24, 89 and 178 random tiles against
    an f64 sum (the kernel's error must not grow with a row's length);
(c) the main path: ``train.run`` trains the 602-16-41 GCN on the bsr backend
    with dropout 0.5 (epoch 1 eagerly, then replays of the epoch's CUDA
    graph); losses must be finite, the train loss must fall, and each kernel
    must have launched on every adjacency pass (4 per epoch, 2 for the
    trailing eval, 2 for the test eval);
(d) time each kernel and its plain version at the main path's four widths,
    beside the least time the card could take (its bound, both parts printed
    at every width) and one PyTorch library call for the same function;
(e) train synth-pubmed on the card and on the CPU (plain versions) from the
    same weights at dropout 0: the metrics must agree;
(f) device time by kernel and the device's busy share, from torch.profiler
    over a few warm epochs (run before (e)), every kernel of the port by name;
    then CUDA events around each launch of kernels 1 and 2 in warm epochs;
(g) the pallas path: synth-pubmed, 500-16-3, backend ``pallas``. Kernel 3
    (ELL SpMM) against its plain version at d 3, 6, 16, 32, and bitwise equal
    to itself across two runs; ``train.run`` 100 epochs at dropout 0.5 with
    finite metrics, a falling train loss, and kernel 3 launched on every
    adjacency pass (4 per epoch + 2 + 2) and no other kernel; card against
    CPU for 3 epochs at dropout 0 within 1e-4; an early-stopping run that
    stops at the same epoch on the card as on the CPU;
(h) kernel 3 at reddit scale, backend ``ell``, on two graphs: synth-reddit as
    it is loaded, and relabelled with its cached locality permutation (the
    main path's dataset). On each: against its plain version at d 16, 32, 41,
    82 and bitwise equal across two runs; timed beside its plain version, a
    sparse CSR product, its bound (every byte once) and a second yardstick,
    the time of the row gathers alone from the memory with no reuse and the
    rate at which the kernel gathered them; the item order that
    ``ops.ell.pick_order`` chose for the graph against the other candidate;
    the steady epoch. Then ``train.run`` 3 epochs with 4 launches per epoch + 4;
(i) the probe kernels (``python -m cuda_gcn_torch.probes.gather``) at the
    script's default shapes: each against its plain version, its time, ns per
    row and bound, and a PyTorch call as the yardstick; for the kernel and for
    the library call, the device time (torch.profiler) and the host's time per
    call apart (``split_times``);
(j) the take-along-axis probes (``python -m cuda_gcn_torch.probes.taa`` and
    ``probes.dyngather``) at every shape, type and step count of the TPU
    scripts: the two gather kernels bitwise equal to their plain versions, the
    column scan and the piece within √S · epsilon · max|cs| of theirs, bitwise
    equal across two runs and to the order of additions that
    ``taa.scan_order_plain`` restates, one CUDA launch a call each (a profiler
    trace in a process of its own), and so at ``SCAN_EDGES``
    (ragged rows and widths, 2^20 + 3 rows in waves, an unaligned table,
    boundaries in any order); each case's time beside its plain version,
    a PyTorch library call where one computes the same function, and its bound;
    device time and host time per call of every case and of its library call,
    taken in turns, and for the gathers the time of their loads from the memory
    with no reuse; k1, k2 and k5 against ``take_along_dim``/``index_select``;
(k) sparse layer-0 features at full width (run while (c)'s graph is alive):
    the CSR product X·W (kernel 2) at d 16 and 32 and its dW = Xᵀ·g (kernel 3's
    work list) at d 16 against ``csr_matmul_plain`` on synth-reddit's features,
    timed beside cuBLAS on dense x and beside dW through kernel 2; ``train.run``
    with ``feature_matmul='sparse'`` for 10 epochs with the launch counts the
    code should make; sparse against dense features at dropout 0 within 1e-4;
    synth-pubmed sparse, card against CPU, within 1e-4;
(l) the text entry point: synth-cora written as cora-text.{graph,split,svmlight},
    parsed back by the native parser array for array, and trained from the files by ``cli.main``
    with ``--feature-matmul sparse`` in the reference's output format;
(m) bf16 activations and weights (run after (e)): on synth-reddit built for
    bf16 activations (bf16 edge coefficients), kernels 1 (both orientations),
    2 (both forms) and 3 at bf16 h, d 16, 32, 41, 82, against their plain
    versions within one bf16 ulp (of the larger of the two values) plus 1e-6
    of the sum of the terms' magnitudes, bitwise repeatable, timed beside their bytes bound
    at bf16 and the library's call where it takes bf16; the dense layer 0 at
    bf16 against the JAX package's form of it; 10 fused epochs on bsr and on
    ell at compute_dtype='bfloat16' and on bsr with param_dtype='bfloat16' too,
    with their profiles and ``train.run``s that count the kernels' launches;
    synth-pubmed at bf16, card against CPU (loss rtol 5e-3, accuracy within 2
    nodes); and ``cli.main(["synth-cora", "--seed", "3", "--epochs", "3"])``,
    which must generate the dataset;
(n) synth-reddit4x (931,860 nodes, 602-16-41, run last): generated with seed 0
    by ``data/synthetic.py``, relabelled by the native LPA (numpy's beside it:
    seconds, labels bit for bit) and built as the bsr graph by numpy's build
    steps (timed, then dropped) and by the native ones, each step's host seconds
    and peak host memory printed with the host's cores and the tile and
    residual edge counts; kernels 1 and 2 against their plain versions at d
    16/32/41/82 (kernel 1's plain version over 32,768 tiles at a time) and
    bitwise repeatable, timed beside their bounds and the library as in (d);
    the dense-feature fused loop, 5 epochs after 2 warm-up ones, with its
    profile, its peak device memory and its launch counts, and the peak with
    the epoch as a CUDA graph (``run_epochs_chunked``); sparse features:
    X·W (kernel 2) and dW (kernel 3) as in (k), 3 fused epochs at dropout 0
    against dense features within rtol 1e-4 / atol 1e-5, and the steady
    sparse loop with its launch counts; then the dense loop on the same graph
    built for the ``segment`` backend (every edge on kernel 2);
(o) the CLI's extras (run after (l)): ``cli.main`` on synth-pubmed at dropout
    0.5, 4 epochs against 2 saved with ``--save-checkpoint`` and 2 more from
    ``--load-checkpoint``: epochs 3-4 and the final checkpoints equal bit for
    bit; ``--metrics-csv``/``--metrics-jsonl`` parse; ``--timing`` prints all
    13 phases, each finite and above 0, with the launches that the resumed run
    and the per-op timing should make; ``--build-kernels`` exits 0.

(p) the sharded trainer (run after (o)): synth-reddit at full width, bsr
    interiors, relabelled and cut by ``reorder.partition_layout`` for P = 1, 2,
    4; world size 1 over NCCL (10 epochs against ``train.run`` on the same
    relabelled dataset within rtol 1e-4 / atol 1e-5, and 4 epochs against 2 +
    a checkpoint + 2 at dropout 0.5, bit for bit); 2 and 4 spawned ranks
    sharing the card over gloo, payloads staged through pinned host memory (5
    epochs at dropout 0 at f32 and bf16 halo, within loss rtol 5e-3 / accuracy
    atol 5e-3 of the single-device run: their parts hold other bf16 tiles); each
    run's launches of kernels 1 and 2 per rank, counted from 0, ms per fused
    epoch per rank, the halo rows and bytes a rank ships an epoch, the
    boundary edge fraction and rank 0's busy share; kernels 1 and 2 against
    their plain versions on rank 0's operators of P=2 (the interior in both
    orientations, the boundary with n_in = halo_space in both), timed beside
    their bounds and the library; ``cli.main synth-pubmed --mesh 1`` against
    the single-device CLI run.
(q) the native host code (run after (a)): g++ builds the three libraries of
    ``cuda_gcn_torch/csrc/host`` (seconds printed); native LPA against numpy's
    on synth-reddit as loaded (labels bit for bit); the main path's bsr graph
    built natively against the numpy build (tiles, tile ids and residual CSR bit
    for bit); synth-pubmed as text through both parsers; ``python -m
    cuda_gcn_torch.data.reddit`` on generated GraphSAGE dumps, then 3 epochs of
    ``cli.main --backend segment`` on its output with kernel 2's launches
    counted. Each time beside the host's core count.
(r) the epoch as a CUDA graph (run after (m)): ``train.run_epochs_chunked``
    against ``train.run_epochs``, each from a fresh ``create_state``, for 100
    epochs at dropout 0.5 on synth-reddit (bsr, 602-16-41) and synth-pubmed
    (pallas): metrics, weights, Adam moments and step and the generator's
    state bit for bit (or within rtol 1e-6, the leaves that differ named),
    launches equal to the eager loop's (4 per epoch + 2), one capture and 99
    replays; each call's ms per epoch, the capture's time and the host's µs
    per replay; then 20 steady epochs of each loop (the graph's replays, the
    eager epoch), three turns each in alternation, with host µs per epoch,
    ms per epoch (each turn and the median) and, under
    torch.profiler, the device's busy share and the port's kernels by name,
    which must be the same in both; early stopping on synth-pubmed ell
    (window 3, dropout 0.5, up to 200 epochs): the graph stops where the
    eager loop does, with equal metrics and state, and the host's cost of a
    read of the stop flag; ``train.run`` 4 epochs against 2 + a checkpoint +
    2, bit for bit; ``cli.main synth-pubmed --prime-cache --compilation-cache
    D`` (a process of its own) builds the 8 libraries into a fresh D, and a
    run of 3 epochs from D in another process, whose compilers are refused,
    builds nothing; the sharded trainer at world size 1 over NCCL,
    ``run_epochs_chunked`` against ``run_epochs`` on synth-pubmed.
(t) the benchmark entry (run after (r)): ``python -m cuda_gcn_torch.bench``
    in a process of its own with its defaults (synth-reddit, bsr, 100
    epochs, f32): one stdout line with a positive ``value``, backend bsr,
    ``device`` naming the card, ``sol_fraction_lower_bound`` in (0, 1.05],
    a finite ``test_acc``; kernels 1 and 2 launched 4 · 100 + 2 times each in
    its measured run (its stderr).
(v) the dense layer-0 kernel (csrc/layer0_pair.cu, run after (j)): at
    ``LAYER0_EDGES`` (all three of its ways through x) and at synth-reddit
    (f32, bf16; and f32 at the GAT's 64 columns, p = 0.6) and pubmed sizes,
    on every row: each xd value 0 or x / (1 - p),
    nonzero only where x is, and bit for bit the plain version's
    (``ops.matmul.layer0_pair_plain``, whose mask is Philox's), the keep
    share within 5 sigma of 1 - p, zt and ze within the f32 sums' bound of
    f64 products of the kernel's own xd and of x (f32 x: also within
    ``ATOL``/``RTOL`` of the plain version's), the train-only launch and a
    second launch equal to the first; the masks of an ``EpochGraph``'s
    epochs equal to the eager epochs' of the same seed, and fresh each
    epoch; then timed by events, and on the device by the profiler in a
    process of its own (events where that reads below the bound), beside its
    bound (bytes; at 64 columns the f32 FMAs), the plain version and the six
    launches of dropout and two cuBLAS products.
(w) the GAT's attention kernels (csrc/gat_attention.cu, run after (v)):
    ``gat_forward``, ``gat_rows`` and ``gat_cols`` against their plain
    version (ops/attention.py) on synth-pubmed in f64 and on synth-reddit in
    f32, at the paper's two layers (8 heads of 8, one of 41) and two more
    shapes, with and without dropout, repeatable bit for bit; every head's
    keep share of the kernel's own mask (read through the forward) within
    4 sigma of 1 - p and equal row by row to ``attention_keep``'s; a captured
    attention's replays drawing the eager epochs' fresh masks; each launch
    timed by events beside its bytes bound and on the device in a process of
    its own; two 100-epoch GAT jobs through the trainer, with their launches
    counted and their epoch time.
(x) kernel 3's blended form (``ell_blend``, GCNII's initial residual, run
    after (w)) on synth-reddit: the single pass at d = 64 with h0, the
    backward's scaled pass without it, and the fused pair at 2 x 64, against
    their plain version (ops/blend.py) and repeatable bit for bit; at a = 1
    without h0 bit for bit kernel 3's own pass; each timed by events and on
    the device (the profiler) beside its bytes bound (columns, coefficients,
    h, h0 and out once); then GCNII at 64 layers of 64 through the trainer:
    3 epochs of the CUDA graph against the eager loop bit for bit, and a
    20-epoch job with its launches an epoch (the epilogue's two kernels 64
    each), its epoch time and its peak memory.
(y) GCNII's convolution epilogue (csrc/gcnii_epilogue.cu, run after (x)) at
    synth-reddit's 232,965 rows of 64: the forward (identity mapping, ReLU, the
    next layer's dropout, both halves side by side or apart) and the backward
    against their plain version (ops/epilogue.py) and ATen on the card: the
    mask ``gcnii_keep``'s bit for bit and its keep share within 5 sigma, the
    outputs within the f32 sums' bound of f64, the kept values ATen's x / (1
    - p) bit for bit, gz ATen's chain bit for bit, repeatable; a captured
    launch's replays drawing the eager epochs' fresh masks; each kernel timed
    by events and on the device beside its bound, and the op beside the ATen
    chain it replaced.

``python3 chip_smoke.py --nccl-graphs`` runs (a) and only (s), on every card
of a machine with two or more: synth-reddit (bsr interiors, dropout 0.5, f32
halo) cut for one NCCL rank a card; on every rank ``sharded.run_epochs_chunked``
(the epoch captured with its halo rounds and all-reduce) against
``sharded.run_epochs`` over 20 epochs, and ``run_epochs_es_chunked`` against
``run_epochs_es``, after 2 eager epochs that set up NCCL: bit for bit, the
same launches and halo rows and bytes; ms per epoch of each whole call; every
card's name and power limit. Then (u): ``python -m cuda_gcn_torch.bench_scaling
--dataset reddit --parts 1,2,4``, one NCCL rank a card: the partition
statistics equal artifacts/partition_stats_reddit.json at P = 1, 2, 4, every P
timed, every rank launching kernels 1 and 2; its payload, and each rank's
steady ms an epoch with the capture left out.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
with all nine kernels (each with ``host_us_per_call``, the host's share of one
call), the dense layer-0 kernel (``layer0_pair``, with its times at the
``LAYER0_SHAPES``), the bf16 variants of kernels 1-3 (``bsr_tile_bf16``,
``csr_spmm_bf16``, ``ell_spmm_bf16``), the GAT's three attention
kernels (``gat_forward``, ``gat_rows``, ``gat_cols``), kernel 3's blended form
(``ell_blend``) and GCNII's epilogue (``gcnii_epilogue``; kernels 1-3 carry their (n) numbers
under ``synth_reddit4x``, kernels 1 and 2 their (p) numbers under ``sharded``), and
last ``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s; f32
# FLOP/s outside the tensor cores, the rate of the gather kernels' and the
# probes' FMAs; dense bf16 FLOP/s of the tensor cores, the rate of kernel 1's
# three bf16 passes.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
EPOCHS = 10               # main-path epochs
WIDTHS = (16, 32, 41, 82)  # pass widths of the main path: pair 32/82, backward 16/41
ATOL, RTOL = 1e-5, 1e-4    # f32; only the summation order differs from the plain version
# the port's device kernels, by a part of their names
PORT_KERNELS = ("split_planes", "bsr_mma", "bsr_tile", "csr_spmm", "ell_spmm", "reduce_partials",
                "layer0_flat", "layer0_pair", "layer0_wide", "ell_blend", "gcnii_epilogue")


def log(msg: str) -> None:
    print(msg, flush=True)


def _clocks() -> str:
    """The card's SM clock (now and its most), memory clock, power draw and
    temperature, as nvidia-smi reads them: printed beside the probes' times,
    which differ between runs."""
    query = "clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        read = res.stdout.strip().splitlines()[0] if res.returncode == 0 else "unread"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        read = "unread"
    return f"{query}: {read}"


def cuda_ms(fn, iters: int) -> float:
    from cuda_gcn_torch.device import cuda_ms as timed

    return timed(fn, iters)


SPLIT_CALLS, SPLIT_BATCHES = 100, 5
PROFILED_CALLS = 20
L2_BYTES = 50e6  # the H100's L2


def _device_us(fn) -> float:
    """Device time per call of ``fn``: the self device time of every kernel
    that torch.profiler saw in ``PROFILED_CALLS`` calls, over their number."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if (dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", ""))
                and not getattr(evt, "is_user_annotation", False)):
            total += dev_us
    return total / PROFILED_CALLS


def split_times(*fns) -> list[dict]:
    """For each of ``fns``, what a call costs where: ``device_us``, the kernels'
    time on the card per call (torch.profiler; CUDA events around 200 launches
    if the profiler saw no kernel, and then ``device_by`` says 'events');
    ``host_us``, the host's time per call, the least over ``SPLIT_BATCHES``
    batches of ``SPLIT_CALLS`` calls that nothing waits for (the host is shared,
    so the least is what the code costs); ``event_us``, CUDA events around the
    same batches, which read the larger of the two. The batches of the
    functions take turns, so that they share the machine's moods."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    host = [[] for _ in fns]
    event = [[] for _ in fns]
    for _ in range(SPLIT_BATCHES):
        for i, fn in enumerate(fns):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            for _ in range(SPLIT_CALLS):
                fn()
            host[i].append((time.perf_counter() - t0) / SPLIT_CALLS * 1e6)
            end.record()
            end.synchronize()
            event[i].append(start.elapsed_time(end) / SPLIT_CALLS * 1e3)
    out = []
    for i, fn in enumerate(fns):
        dev, by = _device_us(fn), "profiler"
        if dev == 0.0:
            dev, by = cuda_ms(fn, 200) * 1e3, "events"
        out.append(dict(device_us=dev, device_by=by, host_us=min(host[i]),
                        event_us=min(event[i])))
    return out


def _fmt_split(t: dict) -> str:
    return (f"device {t['device_us']:.2f} us, host {t['host_us']:.2f} us per call "
            f"(events over {SPLIT_CALLS} calls {t['event_us']:.2f} us)")


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
        spilled, fn = [], ""
        for line in r["log"].splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
                if "spill stores" in line and " 0 bytes spill stores" not in line:
                    spilled.append(fn)
        if spilled:
            log(f"  {name}: spills in {len(spilled)} kernels: {', '.join(spilled)}")


PLAIN_TILE_CHUNK = 32768  # tiles per call of kernel 1's plain version (f32 copies)


def _bsr_plain(graph, rows, cols, h, transpose: bool):
    """Kernel 1's plain version over ``PLAIN_TILE_CHUNK`` tiles at a time,
    the parts added in f32: on synth-reddit4x an f32 copy of all tiles would
    be 23 GB. One call below that many tiles."""
    import torch

    from cuda_gcn_torch.ops.bsr import bsr_tile_contract_plain

    k = graph.num_tiles
    if k <= PLAIN_TILE_CHUNK:
        return bsr_tile_contract_plain(graph.tiles, rows, cols, h, graph.n_nodes,
                                       graph.t_blocks, transpose=transpose)
    out = torch.zeros(graph.n_nodes, h.shape[1], device=h.device)
    for a in range(0, k, PLAIN_TILE_CHUNK):
        b = slice(a, a + PLAIN_TILE_CHUNK)
        out += bsr_tile_contract_plain(graph.tiles[b], rows[b], cols[b], h, graph.n_nodes,
                                       graph.t_blocks, transpose=transpose).float()
    return out.to(h.dtype)


def _describe_graph(graph, label: str, seconds: float) -> None:
    import torch

    covered = graph.total_nnz - graph.resid_nnz
    log(f"{label} graph built in {seconds:.1f} s: n={graph.n_nodes} "
        f"nnz={graph.total_nnz} K={graph.num_tiles} T={graph.t_blocks} "
        f"tb={graph.tb} residual nnz={graph.resid_nnz} "
        f"tile coverage={covered / graph.total_nnz:.4f} symmetric={graph.symmetric}")
    deg = torch.diff(graph.resid.row_ptr.long()).float()
    per_row = torch.diff(graph.plan.ptr.long()).float()
    work = graph.resid.work
    log(f"  residual edges per row: mean {deg.mean():.2f} p99 "
        f"{deg.quantile(0.99):.0f} max {deg.max():.0f}, {int((deg == 0).sum())} rows empty; "
        f"work items {work.beg.numel()} ({work.n_nonempty} with edges, {work.n_partials} "
        f"chunks of {work.split_rows.numel()} long rows); tiles per block row: mean "
        f"{per_row.mean():.2f} p99 {per_row.quantile(0.99):.0f} max {per_row.max():.0f}")


def phase_kernels(dataset, device):
    import torch

    from cuda_gcn_torch.data.graph import build_graph

    t0 = time.perf_counter()
    graph = build_graph(dataset.graph, backend="bsr", device=device)
    torch.cuda.synchronize()
    _describe_graph(graph, "(b)", time.perf_counter() - t0)
    errs = {"bsr_tile": 0.0, "csr_spmm": 0.0}
    check_kernels_1_2(graph, errs)
    return graph, errs


def check_kernels_1_2(graph, errs, label: str = ""):
    """Kernels 1 (both orientations) and 2 (both forms) against their plain
    versions at the main path's widths, and bitwise equal across two runs."""
    import torch

    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, tile_plan
    from cuda_gcn_torch.ops.residual import residual_spmm, residual_spmm_plain

    plan_t = tile_plan(graph.tile_cols, graph.tile_rows, graph.t_blocks)
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = graph.resid
    for d in WIDTHS:
        h = torch.randn(graph.n_nodes, d, generator=gen, device="cuda")
        for transpose in (False, True):
            rows, cols, plan = ((graph.tile_cols, graph.tile_rows, plan_t) if transpose
                                else (graph.tile_rows, graph.tile_cols, graph.plan))

            def tile_part():
                return bsr_tile_contract(graph.tiles, rows, cols, h, graph.n_nodes,
                                         graph.t_blocks, transpose=transpose, plan=plan)

            got = tile_part()
            want = _bsr_plain(graph, rows, cols, h, transpose)
            errs["bsr_tile"] = max(errs["bsr_tile"], check(
                f"bsr_tile{label} d={d} transpose={transpose}", got, want))
            if not torch.equal(got, tile_part()):
                raise AssertionError(f"bsr_tile d={d} differs between two runs")
            del got, want
        got = residual_spmm(r.row_ptr, r.cols, r.coef, h, work=r.work)
        want = residual_spmm_plain(r.row_ptr, r.cols, r.coef, h)
        errs["csr_spmm"] = max(errs["csr_spmm"], check(f"csr_spmm{label} d={d}", got, want))
        base = torch.randn(graph.n_nodes, d, generator=gen, device="cuda")
        got2 = residual_spmm(r.row_ptr, r.cols, r.coef, h, out=base.clone(), work=r.work)
        want = residual_spmm_plain(r.row_ptr, r.cols, r.coef, h, out=base.clone())
        errs["csr_spmm"] = max(errs["csr_spmm"], check(
            f"csr_spmm{label} d={d} accumulate", got2, want))
        if not torch.equal(got, residual_spmm(r.row_ptr, r.cols, r.coef, h, work=r.work)) \
                or not torch.equal(got2, residual_spmm(r.row_ptr, r.cols, r.coef, h,
                                                       out=base.clone(), work=r.work)):
            raise AssertionError(f"csr_spmm d={d} differs between two runs")
    torch.cuda.synchronize()
    log(f"  kernels 1 and 2{label}: bitwise equal across two runs at every width")


def phase_tile_cases(errs):
    """(b), second half: the cases of kernel 1 that the main path does not
    reach, on synth-pubmed: f32 tiles (the FMA kernel), bf16 tiles of size 64
    and 128 (fewer consumer warpgroups), a width between two accumulator
    widths and one above the widest; each for f32 h and for bf16 h (one bf16
    plane on the tensor cores; the FMA kernel reading bf16 h, with f32 tiles
    rounded to bf16), the bf16 ones held as in (m)."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.data.dataset import load_cached, reorder_cached
    from cuda_gcn_torch.data.graph import build_graph
    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, bsr_tile_contract_plain

    ds = reorder_cached(load_cached("synth-pubmed"), "synth-pubmed")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tb, widths in (("float32", 256, (16,)), ("bfloat16", 64, (16, 82)),
                              ("bfloat16", 128, (41,)), ("bfloat16", 256, (60, 100))):
        graph = build_graph(ds.graph, backend="bsr", bsr_tile=tb, bsr_dtype=dtype,
                            device="cuda")
        for d, h_dtype in ((d, h_dtype) for d in widths
                           for h_dtype in (torch.float32, torch.bfloat16)):
            width = kernels.bsr_mma_width(graph.tiles.dtype, tb, graph.num_tiles, d, h_dtype)
            which = "FMA kernel" if width is None else f"tensor cores, N={width}"
            h = torch.randn(graph.n_nodes, d, generator=gen, device="cuda").to(h_dtype)
            for transpose in (False, True):
                rows, cols = ((graph.tile_cols, graph.tile_rows) if transpose
                              else (graph.tile_rows, graph.tile_cols))
                got = bsr_tile_contract(graph.tiles, rows, cols, h, graph.n_nodes,
                                        graph.t_blocks, transpose=transpose)
                want = bsr_tile_contract_plain(graph.tiles, rows, cols, h, graph.n_nodes,
                                               graph.t_blocks, transpose=transpose)
                label = (f"bsr_tile synth-pubmed {dtype} tiles tb={tb} K={graph.num_tiles} d={d} "
                         f"h {str(h_dtype)[6:]} transpose={transpose} ({which})")
                if h_dtype == torch.float32:
                    errs["bsr_tile"] = max(errs["bsr_tile"], check(label, got, want))
                    continue
                mass = bsr_tile_contract_plain(graph.tiles, rows, cols, h.float().abs(),
                                               graph.n_nodes, graph.t_blocks, transpose)
                errs["bsr_tile_bf16"] = max(errs.get("bsr_tile_bf16", 0.0),
                                            check_bf16(label, got, want, mass))
    torch.cuda.synchronize()


def phase_third_part():
    """(b), last: kernel 1 where the third bf16 part of h decides the answer.
    ATOL and RTOL would pass a kernel that dropped it (it carries about 2^-17 of
    a value), so here every h[j, f] is (1 + 2^-9 + 2^-17) · 2^(f mod 5): its
    parts are 1, 2^-9 and 2^-17 times that power of two, none zero. The tiles
    hold 0 and 1, 8 ones a row, 3 tiles a block row at most, so every sum of the
    kernel is exact in f32 and the answer is held against an f64 reference:
    each output within a quarter of what the third part alone contributes."""
    import torch

    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, split_bf16x3

    tb, t_blocks = 256, 3
    n = t_blocks * tb - 6
    tile_rows = torch.tensor([0, 0, 1, 2, 2, 2], device="cuda")
    tile_cols = torch.tensor([0, 2, 1, 0, 1, 2], device="cuda")
    i = torch.arange(tb, device="cuda")
    tiles = torch.stack([((i[None, :] % 32) == ((i[:, None] + p) % 32)) for p in range(6)])
    tiles = tiles.to(torch.bfloat16).contiguous()

    def exact(hh, rows, cols, transpose):
        hp = torch.zeros(t_blocks * tb, hh.shape[1], dtype=torch.float64, device="cuda")
        hp[:n] = hh
        a = tiles.double().transpose(1, 2) if transpose else tiles.double()
        out = torch.zeros(t_blocks, tb, hh.shape[1], dtype=torch.float64, device="cuda")
        out.index_add_(0, rows, torch.bmm(a, hp.view(t_blocks, tb, -1)[cols]))
        return out.view(t_blocks * tb, -1)[:n]

    for d in (41, 82):
        scale = torch.exp2((torch.arange(d, device="cuda") % 5).float())
        h = ((1 + 2.0 ** -9 + 2.0 ** -17) * scale).expand(n, d).contiguous()
        hi, mid, lo = (part.double() for part in split_bf16x3(h))
        if not torch.equal(hi + mid + lo, h.double()) or not bool((lo != 0).all()):
            raise AssertionError("the three parts do not sum to h with a third part in use")
        for transpose in (False, True):
            rows, cols = (tile_cols, tile_rows) if transpose else (tile_rows, tile_cols)
            got = bsr_tile_contract(tiles, rows, cols, h, n, t_blocks, transpose=transpose)
            want = exact(h.double(), rows, cols, transpose)
            third = (want - exact(hi + mid, rows, cols, transpose)).abs()
            ratio = float(((got.double() - want).abs() / third).max())
            ok = bool((third > 0).all()) and ratio <= 0.25
            log(f"  bsr_tile third bf16 part, d={d} transpose={transpose}: max error "
                f"{ratio:.3f} of the third part's share (limit 0.25) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel 1 does not carry the third bf16 part of h")
    torch.cuda.synchronize()


DEEP_ROW_TILES = (24, 89, 178)  # synth-reddit's mean; synth-reddit4x's mean and most


def phase_deep_rows(errs):
    """(b), last: kernel 1 on block rows of many tiles, against an f64 sum.
    16 block rows of 24, 89 or 178 random tiles (5% of entries set, values in
    [0, 0.02)), random h: each output within ATOL/RTOL of the exact sum, with
    the plain f32 version's own distance from it printed beside. The tensor
    cores round a running sum at every wgmma; the kernel adds each tile's sums
    into f32 registers, so the error must not grow with the row's length."""
    import torch

    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, bsr_tile_contract_plain, tile_plan

    t_blocks, tb = 16, 256
    n = t_blocks * tb
    gen = torch.Generator(device="cuda").manual_seed(7)
    for per_row in DEEP_ROW_TILES:
        k = t_blocks * per_row
        keep = torch.rand(k, tb, tb, generator=gen, device="cuda") < 0.05
        tiles = (torch.rand(k, tb, tb, generator=gen, device="cuda") * 0.02 * keep).to(
            torch.bfloat16)
        del keep
        rows = torch.arange(t_blocks, device="cuda").repeat_interleave(per_row).int()
        cols = torch.randint(0, t_blocks, (k,), generator=gen, device="cuda").int()
        plan = tile_plan(rows, cols, t_blocks)
        for d in (16, 82):
            h = torch.randn(n, d, generator=gen, device="cuda")
            exact = torch.zeros(t_blocks, tb, d, dtype=torch.float64, device="cuda")
            exact.index_add_(0, rows.long(), torch.bmm(tiles.double(), h.double().view(
                t_blocks, tb, d)[cols.long()]))
            exact = exact.view(n, d)
            got = bsr_tile_contract(tiles, rows, cols, h, n, t_blocks, plan=plan)
            plain = bsr_tile_contract_plain(tiles, rows, cols, h, n, t_blocks)
            p_err, p_ratio = max_errors(plain.double(), exact)
            log(f"  bsr_tile, block rows of {per_row} tiles, d={d}, against the f64 sum "
                f"(the plain f32 version: max_abs_err={p_err:.3e} max_err/tol={p_ratio:.3f}):")
            errs["bsr_tile"] = max(errs["bsr_tile"], check(
                f"bsr_tile {per_row} tiles a block row d={d}", got.double(), exact))
        del tiles
    torch.cuda.synchronize()


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
        f"(4 per epoch + 2 trailing eval + 2 test eval), layer0_pair {EPOCHS} (one an "
        f"epoch: the dense layer 0 in training), 0 for the others")
    if any(v != (expected if k in ("bsr_tile", "csr_spmm") else EPOCHS if k == "layer0_pair"
                 else 0) for k, v in launches.items()):
        raise AssertionError("a kernel did not run on every adjacency pass")
    return launches


def _features(dataset, sparse: bool, dtype=None):
    """The layer-0 input on the card: dense [N, F], or ``SparseFeatures``, in
    ``dtype`` (f32 by default)."""
    import numpy as np
    import torch

    from cuda_gcn_torch.ops.matmul import SparseFeatures

    dtype = dtype or torch.float32
    if not sparse:
        return torch.from_numpy(dataset.dense_features(np.float32)).cuda().to(dtype)
    fi = dataset.feature_index
    return SparseFeatures.from_csr(fi.indptr, fi.indices, dataset.feature_value,
                                   dataset.input_dim, "cuda", dtype)


def _fused_inputs(dataset, sparse: bool = False, **dtypes):
    """Features, truths and step arguments of the main path, for timing
    ``train.run_epochs`` on an already built graph; ``dtypes`` are the
    config's ``compute_dtype``/``param_dtype``."""
    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig

    cfg = dataset.apply_config(GCNConfig(seed=0, **dtypes))
    x = _features(dataset, sparse, getattr(torch, cfg.compute_dtype))
    truths = [train.make_truth(dataset.split, dataset.label, s, "cuda") for s in (1, 2)]
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay,
              lr=cfg.learning_rate)
    return cfg, x, truths, kw


def phase_steady(graph, dataset, label: str = "", sparse: bool = False,
                 epochs: int = EPOCHS, **dtypes) -> float:
    """ms per fused epoch over ``epochs`` after 2 warm-up epochs (two
    ``run_epochs`` calls, each with its trailing eval)."""
    import torch

    from cuda_gcn_torch import train

    cfg, x, truths, kw = _fused_inputs(dataset, sparse, **dtypes)
    train.run_epochs(train.create_state(cfg, "cuda"), graph, x, *truths, epochs=2, **kw)
    state = train.create_state(cfg, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.run_epochs(state, graph, x, *truths, epochs=epochs, **kw).cpu()
    ms = (time.perf_counter() - t0) * 1e3 / epochs
    log(f"  steady fused loop{label}: {ms:.2f} ms/epoch over {epochs} epochs "
        f"(incl. the trailing eval)")
    return ms


def phase_profile(graph, dataset, epochs: int = 3, label: str = "(f)", **dtypes):
    """torch.profiler over a few warm fused epochs: device time by kernel and
    the device's busy share of the wall time. Returns {wall_ms, busy_ms} per
    epoch and the device ms per epoch of every kernel of the port."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuda_gcn_torch import train

    cfg, x, truths, kw = _fused_inputs(dataset, **dtypes)
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
        if (dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", ""))
                and not getattr(evt, "is_user_annotation", False)):
            kernels_ms[evt.key] = kernels_ms.get(evt.key, 0.0) + dev_us / 1e3
    busy = sum(kernels_ms.values())
    log(f"{label} profile of {epochs} warm fused epochs: wall {wall_ms / epochs:.2f} "
        f"ms/epoch, device busy {busy / epochs:.2f} ms/epoch ({busy / wall_ms:.3f} of wall)")
    ranked = sorted(kernels_ms.items(), key=lambda kv: -kv[1])
    own = PORT_KERNELS
    for i, (name, ms) in enumerate(ranked):  # the top 8, and every kernel of the port
        if i < 8 or any(key in name for key in own):
            log(f"  {ms / epochs:9.3f} ms/epoch  {name[:110]}")
    rest = sum(ms for name, ms in ranked if not any(key in name for key in own))
    log(f"  {rest / epochs:9.3f} ms/epoch  everything that is no kernel of the port")
    return dict(wall_ms=wall_ms / epochs, busy_ms=busy / epochs, busy_share=busy / wall_ms,
                not_port_ms=rest / epochs,
                port_ms={key: sum(ms for name, ms in ranked if key in name) / epochs
                         for key in own})


def phase_epoch_events(graph, dataset, epochs: int = 3):
    """(f), second half: CUDA events around every launch of kernels 1 and 2
    inside warm fused epochs, without the profiler: a pass's time in the loop
    (kernel 1's pre-pass and kernel 2's reduce kernel included), by width."""
    import torch

    from cuda_gcn_torch import kernels, train

    cfg, x, truths, kw = _fused_inputs(dataset)
    state = train.create_state(cfg, "cuda")
    train.run_epochs(state, graph, x, *truths, epochs=2, **kw)
    events = []
    real = {"bsr_tile": kernels.bsr_tile, "csr_spmm": kernels.csr_spmm}

    def timed(name, h_at):
        def launch(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = real[name](*args, **kwargs)
            end.record()
            events.append((name, int(args[h_at].shape[1]), start, end))
            return out
        return launch

    kernels.bsr_tile, kernels.csr_spmm = timed("bsr_tile", 4), timed("csr_spmm", 3)
    try:
        train.run_epochs(state, graph, x, *truths, epochs=epochs, **kw)
        torch.cuda.synchronize()
    finally:
        kernels.bsr_tile, kernels.csr_spmm = real["bsr_tile"], real["csr_spmm"]
    per_epoch = {"bsr_tile": 0.0, "csr_spmm": 0.0}
    by_width = {}
    # the trailing eval's two passes are left out: whole epochs only
    for name, d, start, end in events[:8 * epochs]:
        ms = start.elapsed_time(end)
        per_epoch[name] += ms / epochs
        by_width.setdefault((name, d), []).append(ms)
    log(f"  CUDA events around each launch in {epochs} warm fused epochs: kernel 1 "
        f"{per_epoch['bsr_tile']:.3f} ms/epoch, kernel 2 {per_epoch['csr_spmm']:.3f} ms/epoch; "
        "per pass " + ", ".join(f"{name} d={d} {sum(v) / len(v):.3f}"
                                for (name, d), v in by_width.items()))
    return per_epoch


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


def phase_timing(graph, launches, errs, label: str = "(d)"):
    import dataclasses

    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.ops.bsr import bsr_tile_contract
    from cuda_gcn_torch.ops.residual import residual_spmm, residual_spmm_plain

    n, k, tb, t_blocks = graph.n_nodes, graph.num_tiles, graph.tb, graph.t_blocks
    r = graph.resid
    m = r.nnz
    gen = torch.Generator(device="cuda").manual_seed(1)
    csr = torch.sparse_csr_tensor(r.row_ptr.long(), r.cols.long(), r.coef, size=(n, n))
    tile_bytes = graph.tiles.numel() * graph.tiles.element_size()
    by_width = {"bsr_tile": {}, "csr_spmm": {}}
    log(f"{label} timing at the main path's shapes (CUDA events, warm, mean of iters); bounds: "
        "each input read once and each output written once over 3.35 TB/s, against kernel "
        "1's three bf16 passes at its accumulator width N over 989 TFLOP/s and kernel 2's "
        "f32 FMAs over 67 TFLOP/s")
    for d in WIDTHS:
        h = torch.randn(n, d, generator=gen, device="cuda")
        t1 = cuda_ms(lambda: bsr_tile_contract(graph.tiles, graph.tile_rows, graph.tile_cols,
                                               h, n, t_blocks, plan=graph.plan), 20)
        p1 = cuda_ms(lambda: _bsr_plain(graph, graph.tile_rows, graph.tile_cols, h, False), 3)
        out = torch.zeros(n, d, device="cuda")
        t2 = cuda_ms(lambda: residual_spmm(r.row_ptr, r.cols, r.coef, h, out=out,
                                           work=r.work), 20)
        t2_new = cuda_ms(lambda: residual_spmm(r.row_ptr, r.cols, r.coef, h, work=r.work), 20)
        p2 = cuda_ms(lambda: residual_spmm_plain(r.row_ptr, r.cols, r.coef, h, out=out), 5)
        l2, _ = _library_ms(lambda: (lambda: csr @ h), 20)
        l2_add, _ = _library_ms(lambda: (lambda: out.addmm_(csr, h)), 20)
        # bounds: each input read once, each output written once
        width = kernels.bsr_mma_width(graph.tiles.dtype, tb, k, d)
        b1_bytes = tile_bytes + 4 * (2 * k + 2 * t_blocks + 1) + 4 * n * d + 4 * n * d
        b1_ops = (3 * 2 * k * tb * tb * width / PEAK_BF16_FLOPS if width is not None
                  else 2 * k * tb * tb * d / PEAK_F32_FLOPS) * 1e3
        # kernel 2 adding into out: the items, the edges, h, out read and written
        b2_bytes = 12 * r.work.beg.numel() + 8 * m + 4 * n * d + 2 * 4 * n * d
        b2_ops = 2 * m * d / PEAK_F32_FLOPS * 1e3
        for name, ms, plain, nbytes, t_ops in (("bsr_tile", t1, p1, b1_bytes, b1_ops),
                                               ("csr_spmm", t2, p2, b2_bytes, b2_ops)):
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            by_width[name][d] = dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                                     bound_bytes_ms=t_bytes, bound_operations_ms=t_ops)
        by_width["bsr_tile"][d]["accumulator_width"] = width
        by_width["csr_spmm"][d].update(new_out_ms=t2_new, library_ms=l2,
                                       library_addmm_ms=l2_add)
        b1, b2 = by_width["bsr_tile"][d], by_width["csr_spmm"][d]
        log(f"  d={d}: bsr_tile {t1:.3f} ms (N={width}; plain {p1:.3f}; bound "
            f"{b1['bound_ms']:.3f} ms by {b1['bound_by']}: bytes {b1['bound_bytes_ms']:.3f}, "
            f"operations {b1['bound_operations_ms']:.3f})")
        log(f"  d={d}: csr_spmm adding into out {t2:.3f} ms, into a new tensor {t2_new:.3f} ms "
            f"(plain {p2:.3f}; library sparse CSR @ dense {_fmt_ms(l2)}, out.addmm_ "
            f"{_fmt_ms(l2_add)}; bound {b2['bound_ms']:.3f} ms by {b2['bound_by']}: bytes "
            f"{b2['bound_bytes_ms']:.3f}, operations {b2['bound_operations_ms']:.3f})")
    d = WIDTHS[-1]
    h = torch.randn(n, d, generator=gen, device="cuda")

    def bsr_lib():
        a = torch.sparse_bsr_tensor(graph.plan.ptr.long(), graph.tile_cols.long(),
                                    graph.tiles.float(), size=(t_blocks * tb, t_blocks * tb))
        hp = torch.zeros(t_blocks * tb, d, device="cuda")
        hp[:n] = h
        return lambda: a @ hp

    l1, note1 = _library_ms(bsr_lib, 3)
    log(f"  library at d={d}: sparse BSR @ dense (f32 values) "
        f"{'%.3f ms' % l1 if l1 is not None else 'did not run (' + note1 + ')'}")
    in_row_order = dataclasses.replace(graph.plan, by_load=None)
    t1_rows = cuda_ms(lambda: bsr_tile_contract(graph.tiles, graph.tile_rows, graph.tile_cols,
                                                h, n, t_blocks, plan=in_row_order), 20)
    log(f"  bsr_tile at d={d} with the block rows taken in row order instead of most tiles "
        f"first: {t1_rows:.3f} ms")
    out = torch.zeros(n, d, device="cuda")
    split = dict(zip(("bsr_tile", "csr_spmm"), split_times(
        lambda: bsr_tile_contract(graph.tiles, graph.tile_rows, graph.tile_cols, h, n, t_blocks,
                                  plan=graph.plan),
        lambda: residual_spmm(r.row_ptr, r.cols, r.coef, h, out=out, work=r.work))))
    for name, t in split.items():
        log(f"  {name} at d={d}, where its call's time goes: {_fmt_split(t)}")
    kernels_line = []
    for name, src, replaces, lib in (
            ("bsr_tile", "cuda_gcn_torch/csrc/bsr_tile.cu",
             "cuda_gcn_tpu/ops/pallas_bsr.py:65 (+ :120 _bsr_kernel_resident)", l1),
            ("csr_spmm", "cuda_gcn_torch/csrc/csr_spmm.cu",
             "cuda_gcn_tpu/ops/graphsum.py:136 (XLA _blocked2d_apply, not Pallas)",
             by_width["csr_spmm"][d]["library_ms"])):
        row = by_width[name][d]
        kernels_line.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": lib, "d": d,
            "host_us_per_call": split[name]["host_us"], "device_us": split[name]["device_us"],
            "by_width": {str(w): v for w, v in by_width[name].items()}})
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
    """(bound ms, 'bytes' or 'operations') for a byte count and f32 operations."""
    return _bound_at(nbytes, ops / PEAK_F32_FLOPS)[:2]


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
    """{d: {ms, plain_ms, library_ms, bound_ms, bound_by, gather_no_reuse_ms,
    gather_tb_per_s, h_fits_l2}}. Beside the bound (every byte once) stands the
    time of the row gathers alone if none were reused, nnz · 4d bytes at the
    memory's rate, and the rate at which the kernel gathered them: a rate above
    the memory's 3.35 TB/s is the caches' work."""
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
        gather_bytes = plan.nnz * 4 * d
        fits = 4 * plan.n_nodes * d <= L2_BYTES
        rows[d] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                       gather_no_reuse_ms=gather_bytes / PEAK_BYTES_PER_S * 1e3,
                       gather_tb_per_s=gather_bytes / ms / 1e9, h_fits_l2=fits)
        log(f"  {label} d={d}: ell_spmm {ms:.4f} ms (plain {plain:.3f}; library "
            f"{'%.4f ms' % lib if lib is not None else note}; bound {bound:.4f} ms, {by}; the "
            f"row gathers alone with no reuse {rows[d]['gather_no_reuse_ms']:.4f} ms, gathered "
            f"at {rows[d]['gather_tb_per_s']:.2f} TB/s; h is {4 * plan.n_nodes * d / 1e6:.1f} MB"
            f"{', fits L2' if fits else ', exceeds L2'})")
    return rows


def _time_ell_orders(plan, widths, label, gen):
    """Kernel 3 with its items in the order that ``pick_order`` chose for this
    graph against the other candidate, in turns: {order: {d: ms}}."""
    import torch

    from cuda_gcn_torch.ops.ell import ell_spmm, with_order

    other = "blocks" if plan.order == "longest" else "longest"
    plans = {plan.order: plan, other: with_order(plan, other)}
    out = {o: {} for o in plans}
    for d in widths:
        h = torch.randn(plan.n_nodes, d, generator=gen, device="cuda")
        if not torch.equal(ell_spmm(plans[other], h), ell_spmm(plan, h)):
            raise AssertionError(f"ell_spmm {label} d={d}: the item order changed the result")
        times = {o: [] for o in plans}
        for _ in range(2):
            for o, p in plans.items():
                times[o].append(cuda_ms(lambda: ell_spmm(p, h), 20))
        for o in plans:
            out[o][str(d)] = min(times[o])
        log(f"  {label} d={d}: items '{plan.order}' (as shipped for this graph) "
            f"{out[plan.order][str(d)]:.4f} ms, '{other}' {out[other][str(d)]:.4f} ms")
    return out


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
        f"(order '{plan.order}') chunked rows={plan.split_rows.numel()} "
        f"symmetric={graph.symmetric}")
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
    log(f"  launches {launches}; expected ell_spmm {expected}, layer0_pair {PUBMED_EPOCHS} (one "
        f"an epoch), every other kernel 0")
    if launches["ell_spmm"] != expected or launches["layer0_pair"] != PUBMED_EPOCHS or any(
            v for k, v in launches.items() if k not in ("ell_spmm", "layer0_pair")):
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
    """(h): kernel 3 on synth-reddit as it is loaded and relabelled with the
    cached locality permutation (the main path's dataset). Returns
    {graph: {"timing", "orders", "epoch_ms", "order"}} and the split times of a
    call at d = 82 on the graph as loaded."""
    import numpy as np
    import torch

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached, reorder_cached
    from cuda_gcn_torch.data.graph import build_graph, normalization_coefficients
    from cuda_gcn_torch.ops.ell import ell_spmm

    raw = load_cached("synth-reddit")
    out, split = {}, None
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, ds in (("as loaded", raw),
                      ("relabelled", reorder_cached(raw, "synth-reddit"))):
        t0 = time.perf_counter()
        graph = build_graph(ds.graph, backend="ell", device="cuda")
        torch.cuda.synchronize()
        plan = graph.ell
        log(f"(h) kernel 3 at reddit scale: synth-reddit {label}, ell graph built in "
            f"{time.perf_counter() - t0:.1f} s: n={plan.n_nodes} nnz={plan.nnz} ELL slots="
            f"{plan.slots} buckets={len(plan.widths)} (widths {plan.widths[0]}.."
            f"{plan.widths[-1]}) work items={plan.work_beg.numel()} in the order "
            f"'{plan.order}' chunked rows={plan.split_rows.numel()} "
            f"partials={plan.n_partials}")
        name = f"synth-reddit {label}"
        _check_ell(plan, WIDTHS, name, gen, errs, bitwise=True)
        indptr = ds.graph.indptr.astype(np.int64)
        indices = ds.graph.indices.astype(np.int64)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(indptr).cuda(), torch.from_numpy(indices).cuda(),
            torch.from_numpy(normalization_coefficients(indptr, indices)).cuda(),
            size=(plan.n_nodes, plan.n_nodes))
        timing = _time_ell(plan, WIDTHS, name, gen, library_csr=csr)
        del csr
        orders = _time_ell_orders(plan, WIDTHS, name, gen)
        epoch_ms = phase_steady(graph, ds, f" (synth-reddit {label}, ell)")
        if split is None:
            h = torch.randn(plan.n_nodes, WIDTHS[-1], generator=gen, device="cuda")
            (split,) = split_times(lambda: ell_spmm(plan, h))
            log(f"  ell_spmm at d={WIDTHS[-1]}, where its call's time goes: {_fmt_split(split)}")
        phase_profile(graph, ds, label=f"  ell backend, {label},")
        out[label] = dict(timing=timing, orders=orders, epoch_ms=epoch_ms, order=plan.order)
        del graph, plan
        torch.cuda.empty_cache()

    cfg = GCNConfig(epochs=REDDIT_ELL_EPOCHS, graphsum_backend="ell", seed=0)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = train.run(cfg, raw, device="cuda", verbose=False)
    launches = dict(kernels.launches)
    expected = 4 * REDDIT_ELL_EPOCHS + 4
    log(f"  train.run {raw.input_dim}-{cfg.hidden_dim}-{raw.output_dim} ell, "
        f"{REDDIT_ELL_EPOCHS} epochs: {time.perf_counter() - t0:.1f} s (graph build "
        f"included), fused loop {res.total_train_time * 1e3 / REDDIT_ELL_EPOCHS:.2f} "
        f"ms/epoch; launches {launches}, expected ell_spmm {expected}")
    if not np.isfinite(_metrics(res)).all():
        raise AssertionError("non-finite metrics on the reddit ell run")
    if launches["ell_spmm"] != expected:
        raise AssertionError("the reddit ell run did not go through kernel 3")
    return out, split


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
    log(f"(i) probes at table [{rows}, {d}], m={m}, mb={mb}: launches {launches}; {_clocks()}")
    errs["gather_probe"] = _gather_check(idx, h)
    errs["scatter_probe"] = _scatter_check(idx_sorted, coef, h, mb)
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
    fn_lib_b = scatter_lib()
    split = split_times(lambda: probes.gather_probe(idx, h),
                        lambda: h.index_select(0, idx).sum(0),
                        lambda: probes.scatter_probe(idx_sorted, coef, h, mb), fn_lib_b)
    out = {}
    for name, key, plain, lib, (bound, by), count, own, lib_split in (
            ("gather_probe", "A", plain_a, lib_a, bound_a, m, split[0], split[1]),
            ("scatter_probe", "B", plain_b, lib_b, bound_b, mb, split[2], split[3])):
        ms = res[key]["ms"]
        log(f"  {name}: {ms:.4f} ms = {res[key]['ns_per_row']:.4f} ns/"
            f"{'id' if key == 'A' else 'row'} over {count} (plain {plain:.4f} ms; library "
            f"{'%.4f ms' % lib if lib is not None else 'did not run'}; bound "
            f"{bound:.4f} ms, {by})")
        log(f"    the kernel: {_fmt_split(own)}; the library call: {_fmt_split(lib_split)}")
        out[name] = dict(launches=launches[name], ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by, ns_per_row=res[key]["ns_per_row"],
                         device_us=own["device_us"], host_us_per_call=own["host_us"],
                         library_device_us=lib_split["device_us"],
                         library_host_us_per_call=lib_split["host_us"])
    a = out["gather_probe"]
    a["path"] = kernels.gather_probe_path(rows)
    log(f"  gather_probe ({a['path']} counts): device {a['device_us']:.2f} us against its bytes "
        f"bound {bound_a[0] * 1e3:.2f} us (idx, h and out once) and the {4 * m * d / 1e6:.0f} MB "
        f"of row gathers of the design it replaced, {4 * m * d / PEAK_BYTES_PER_S * 1e6:.1f} us "
        f"from the memory with no reuse")
    a["above_shared"] = _gather_above_shared()
    _gather_edges()
    b = out["scatter_probe"]
    b.update(_own_process_launches("_scatter_trace()")["scatter_probe"])
    log(f"  scatter_probe: device {b['trace_device_us']:.2f} us a launch by the trace in a process "
        f"of its own, {b['device_us']:.2f} us by this process's (_device_us); bound "
        f"{bound_b[0] * 1e3:.2f} us ({bound_b[1]})")
    _scatter_edges()
    return out


GATHER_GLOBAL_SHAPE = (1 << 17, 1 << 20, 128)  # rows, m, d: counts beyond shared memory


def _gather_check(idx, h) -> float:
    """Probe A against its plain version: a sum of m terms, so the tolerance is
    1e-6 of the sum of their magnitudes; and the same bits on two calls."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.probes import gather as probes

    got = probes.gather_probe(idx, h)
    want = probes.gather_probe_plain(idx, h)
    mass = probes.gather_probe_plain(idx, h.abs())
    err = float((got - want).abs().max())
    ratio = float(((got - want).abs() / (1e-6 * mass)).max())
    log(f"  gather_probe [{h.shape[0]}, {h.shape[1]}] m={idx.numel()} "
        f"({kernels.gather_probe_path(h.shape[0])} counts): max_abs_err={err:.3e} "
        f"max_err/tol={ratio:.3f} (tol 1e-6 * sum_i |h[idx[i]]|) "
        f"{'ok' if ratio <= 1 else 'FAIL'}")
    if ratio > 1 or not torch.equal(got, probes.gather_probe(idx, h)):
        raise AssertionError("gather_probe disagrees with its plain version or itself")
    return err


def _gather_above_shared() -> dict:
    """(i), second shape: a table whose int32 counts do not fit a block's shared
    memory, so the kernel counts into device memory; checked and timed."""
    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.probes import gather as probes

    rows, m, d = GATHER_GLOBAL_SHAPE
    x = probes.make_inputs(rows, m, d, seed=1, device="cuda")
    idx, h = x["idx"], x["h"]
    path = kernels.gather_probe_path(rows)
    if path != "global":
        raise AssertionError(f"gather_probe at {rows} rows took the {path} path")
    err = _gather_check(idx, h)
    bound, by = _bound(4 * m + 4 * rows * d + 4 * d, m * d)
    own, lib = split_times(lambda: probes.gather_probe(idx, h),
                           lambda: h.index_select(0, idx).sum(0))
    plain = cuda_ms(lambda: probes.gather_probe_plain(idx, h), 3)
    log(f"  gather_probe [{rows}, {d}] m={m} ({path} counts): {_fmt_split(own)}; bound "
        f"{bound * 1e3:.2f} us ({by}); row gathers with no reuse "
        f"{4 * m * d / PEAK_BYTES_PER_S * 1e6:.1f} us; plain {plain:.4f} ms; library "
        f"index_select + sum: {_fmt_split(lib)}")
    return dict(rows=rows, m=m, d=d, path=path, max_abs_err=err, ms=own["event_us"] / 1e3,
                device_us=own["device_us"], host_us_per_call=own["host_us"], plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib["event_us"] / 1e3,
                library_device_us=lib["device_us"])


def _gather_edges() -> None:
    """(i), the count kernel's ragged ends and its stray ids, on both paths: ids
    read from 1-3 ints past a 16-byte boundary, m odd (down to one id, fewer
    than a 16-byte load), held as the main shape is; and an id outside [0,
    rows) makes every element of the result NaN."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.probes import gather as probes

    for rows, d in ((16384, 128), (GATHER_GLOBAL_SHAPE[0], 32)):
        x = probes.make_inputs(rows, (1 << 16) + 8, d, seed=2, device="cuda")
        ids, h = x["idx"], x["h"]
        for off, m in ((1, (1 << 16) + 3), (2, 4097), (3, 3), (1, 1)):
            _gather_check(ids[off:off + m], h)
        for stray in (rows, -1):
            bad = ids[:1001].clone()
            bad[500] = stray
            if not bool(torch.isnan(probes.gather_probe(bad, h)).all()):
                raise AssertionError(f"gather_probe counted the stray id {stray} of a table of "
                                     f"{rows} rows")
        log(f"  gather_probe [{rows}, {d}] ({kernels.gather_probe_path(rows)} counts): the ids "
            f"{rows} and -1 each make the result NaN")


def _scatter_check(idx, coef, h, mb: int, label: str = "") -> float:
    """Probe B against its plain version run on CPU copies, which adds in the
    TPU loop's order: bit for bit, and the same bits on two calls. Returns
    the max abs error, 0."""
    import torch

    from cuda_gcn_torch.probes import gather as probes

    got = probes.scatter_probe(idx, coef, h, mb)
    want = probes.scatter_probe_plain(idx.cpu(), coef.cpu(), h.cpu(), mb)
    err = float((got.cpu() - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"scatter_probe [{h.shape[0]}, {h.shape[1]}] mb={mb}{label}: not the "
                             f"TPU loop's bits (max abs difference {err:.3e})")
    if not torch.equal(got, probes.scatter_probe(idx, coef, h, mb)):
        raise AssertionError(f"scatter_probe{label} differs between two runs")
    log(f"  scatter_probe [{h.shape[0]}, {h.shape[1]}] mb={mb}{label}: bit for bit the plain "
        f"version on CPU copies (the TPU loop's order), two runs equal")
    return err


def _scatter_edges() -> None:
    """(i), probe B off its main case: d = 41; h 4 bytes past a 16-byte
    boundary (a contiguous view of a flat buffer at offset 1: 4 values a warp
    apart); mb 0 and 1; every term in one row; each held bit for bit. Then
    ids that are not sorted (a swapped pair) or leave the table (an id of
    rows first, one of -1 last; the rest sorted) make every element NaN."""
    import torch

    from cuda_gcn_torch.probes import gather as probes

    rows, m, mb = 16384, 1 << 20, probes.SCATTER_MAX
    x = probes.make_inputs(rows, m, 41, 0, "cuda")
    _scatter_check(x["idx_sorted"], x["coef"], x["h"], mb, " (d 41)")
    x = probes.make_inputs(rows, m, 128, 0, "cuda")
    idx, coef, h = x["idx_sorted"], x["coef"], x["h"]
    flat = torch.empty(h.numel() + 1, device="cuda")
    flat[1:] = h.reshape(-1)
    off = flat[1:].view(rows, 128)
    if off.data_ptr() % 16 != 4:
        raise AssertionError("the offset view of h is not 4 bytes past a 16-byte boundary")
    _scatter_check(idx, coef, off, mb, " (h 4 bytes past a 16-byte boundary)")
    for n in (0, 1):
        _scatter_check(idx, coef, h, n)
    _scatter_check(torch.full_like(idx, 617), coef, h, mb, " (every term in row 617)")
    faults = {"a swapped pair": idx.clone(), f"an id of {rows}": idx.clone(),
              "an id of -1": idx.clone()}
    faults["a swapped pair"][[100, 30000]] = idx[[30000, 100]]
    faults[f"an id of {rows}"][mb - 1] = rows
    faults["an id of -1"][0] = -1
    for what, bad in faults.items():
        if not bool(torch.isnan(probes.scatter_probe(bad, coef, h, mb)).all()):
            raise AssertionError(f"scatter_probe did not make the result NaN for {what}")
        log(f"  scatter_probe: {what} makes every element of the result NaN")


TAA_ITERS = 5  # the probe entry points' default


def _fmt_ms(v) -> str:
    return "none" if v is None else f"{v:.4f}"


def _one_step_library(idx, strides, tab, axis: int):
    """One ``take_along_dim`` over the first of a case's steps: out[i, j] =
    tab[ind[i, j], j] on axis 0, tab[i, ind[i, j]] on axis 1, with ind[i, j] =
    idx[i·si + j·sj]. It computes one of the case's steps × reps gathers, for
    the cases where no single call computes them all."""
    import torch

    s, l = tab.shape
    si, sj, _ = strides
    pos = (torch.arange(s, device=tab.device)[:, None] * si
           + torch.arange(l, device=tab.device)[None, :] * sj)
    ind = idx.reshape(-1).long()[pos]
    return lambda: torch.take_along_dim(tab, ind, axis)


def _gather_library(case):
    """One PyTorch call that computes a gather case's function, or None: a
    single step has ``take_along_dim``/``index_select``, a compact f32 row
    gather ``embedding_bag`` with mode 'sum'; the other multi-step or repeated
    sums have none."""
    import torch

    idx, tab = case.idx, case.tab
    if case.reps == 1 and case.steps == 1:
        if case.form in ("bcast_rows", "take_rows"):
            flat = idx.reshape(-1)
            return lambda: tab.index_select(0, flat)
        idx64 = idx.long()
        return lambda: torch.take_along_dim(tab, idx64, case.axis)
    if case.reps == 1 and case.form == "compact_rows" and tab.dtype == torch.float32:
        return lambda: torch.nn.functional.embedding_bag(idx, tab, mode="sum")
    return None


def phase_taa_probes(errs):
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.probes import dyngather, taa

    kernels.reset_launches()
    res = taa.run(iters=TAA_ITERS)
    timed = dyngather.run("all", iters=TAA_ITERS)
    launches = dict(kernels.launches)
    per = TAA_ITERS + 1  # a warm-up and the timed launches of each case
    n_rows = sum(c.axis == 0 for c, _ in timed)
    expected = {"taa_rows": per * (n_rows + 1), "taa_lanes": per * (len(timed) - n_rows),
                "cumsum_cols": per, "piece": per + 1}
    log(f"(j) TAA probes: launches {launches}; expected {expected} ({per} per case: A2 and "
        f"{n_rows} axis-0 cases, {len(timed) - n_rows} axis-1 cases, C, D and D's spot "
        f"check), 0 for the others; {_clocks()}")
    if any(v != expected.get(k, 0) for k, v in launches.items()):
        raise AssertionError("the probe entry points did not launch every case's kernel")
    if not res["D_check"]["ok"]:
        raise AssertionError(f"probe D's spot check failed: {res['D_check']}")

    x, s, reps = res["inputs"], res["s"], res["reps"]
    tab, ids, coef, begin, end = (x[k] for k in ("tab", "ids", "coef", "begin", "end"))
    rows_sorted = x["rows_sorted"].long()
    elems = tab.numel()
    out = {k: {"launches": launches[k], "cases": []}
           for k in ("taa_rows", "taa_lanes", "cumsum_cols", "piece")}

    def record(kernel, label, ms, plain_ms, lib_ms, lib_name, bound, err, fns, head=False,
               gather_bytes=None):
        """``fns``: the kernel's call and, where there is one, the library's."""
        bound_ms, by = bound
        own, *rest = split_times(*fns)
        log(f"  {kernel} {label}: {ms:.4f} ms at its entry point (plain {plain_ms:.4f}; "
            f"library {_fmt_ms(lib_ms)}{' ' + lib_name if lib_name else ''}; bound "
            f"{bound_ms:.5f} ms, {by}); max_abs_err {err:.3e}")
        log(f"    the kernel: {_fmt_split(own)}"
            + (f"; the library call: {_fmt_split(rest[0])}" if rest else ""))
        # ms and library_ms: events over the batches taken in turns, one method
        # for both; the entry point's own reading (5 launches) beside them
        row = dict(case=label, ms=own["event_us"] / 1e3, entry_point_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library=lib_name, bound_ms=bound_ms, bound_by=by,
                   max_abs_err=err, device_us=own["device_us"],
                   host_us_per_call=own["host_us"], event_us=own["event_us"])
        if rest:
            row.update(library_ms=rest[0]["event_us"] / 1e3, library_alone_ms=lib_ms,
                       library_device_us=rest[0]["device_us"],
                       library_host_us_per_call=rest[0]["host_us"],
                       library_event_us=rest[0]["event_us"])
        if gather_bytes is not None:
            # beside the bound: the rows or elements gathered, every one from the
            # memory with no reuse, and the rate at which the kernel gathered them
            row.update(gather_no_reuse_ms=gather_bytes / PEAK_BYTES_PER_S * 1e3,
                       gather_tb_per_s=gather_bytes / own["device_us"] / 1e6)
            log(f"    gathers {gather_bytes / 1e6:.1f} MB a launch: {row['gather_no_reuse_ms']:.4f}"
                f" ms from the memory with no reuse; gathered at {row['gather_tb_per_s']:.2f} "
                f"TB/s of device time")
        out[kernel]["cases"].append(row)
        if head:
            out[kernel].update({k: v for k, v in row.items() if k != "case"}, case=label)
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        return row

    # the gathers: bitwise equal to their plain versions (same additions, same order)
    a2 = taa.taa_probe(ids, tab, reps)
    if not torch.equal(a2, taa.taa_probe_plain(ids, tab, reps)):
        raise AssertionError("probe A2 differs from its plain version")
    a2_lib = _one_step_library(ids, (1, 0, 0), tab, 0)
    record("taa_rows", f"A2 [{s}x{taa.LANES}] f32 x{reps} reps", res["A2"]["ms"],
           cuda_ms(lambda: taa.taa_probe_plain(ids, tab, reps), 3), cuda_ms(a2_lib, 10),
           f"take_along_dim, one of the {reps} reps", _bound(4 * s + 8 * elems, elems * reps),
           0.0, (lambda: taa.taa_probe(ids, tab, reps), a2_lib), gather_bytes=4 * elems * reps)
    heads = {"single TAA axis0, full idx", "single TAA axis1 [16x8192]"}
    versus = []
    for case, ms in timed:
        got, want = case.run(), case.plain()
        if got.dtype != torch.float32 or not torch.equal(got, want):
            raise AssertionError(f"{case.label}: the kernel differs from its plain version "
                                 f"(max abs err {float((got - want).abs().max()):.3e})")
        lib = _gather_library(case)
        lib_name = "" if lib is None else (
            "embedding_bag" if case.steps > 1 else
            "index_select" if case.form in ("bcast_rows", "take_rows") else "take_along_dim")
        if lib is None:  # no single call: one step of the case's, by take_along_dim
            lib = _one_step_library(case.idx, case.strides, case.tab, case.axis)
            lib_name = f"take_along_dim, one of the {case.steps * case.reps} steps x reps"
        lib_ms = cuda_ms(lib, 10)
        n = case.tab.numel()
        item = case.tab.element_size()
        bound = _bound(4 * case.idx.numel() + item * n + 4 * n, n * case.steps * case.reps)
        if case.axis == 1:
            form = kernels.taa_lanes_form(case.strides, *case.tab.shape, case.steps, item)
            log(f"  taa_lanes {case.label}: {form.form} form, {form.rows} rows a CTA, "
                f"tile {form.tile} columns")
        row = record("taa_rows" if case.axis == 0 else "taa_lanes", case.label, ms,
                     cuda_ms(case.plain, 2), lib_ms, lib_name, bound, 0.0, (case.run, lib),
                     head=case.label in heads, gather_bytes=item * n * case.steps * case.reps)
        if case.axis == 1:
            row["form"] = form._asdict()
        log("    " + dyngather.rate_line(case, ms).replace("\n", " "))
        if case.group == "bisect" and case.axis == 0 and case.steps == 1:
            versus.append((case.label, lib_name, row))
    _lanes_edges()
    for label, lib_name, row in versus:  # k1, k2, k5 against the library's call
        log(f"  {label} against {lib_name}: device {row['device_us']:.2f} / "
            f"{row['library_device_us']:.2f} us, host {row['host_us_per_call']:.2f} / "
            f"{row['library_host_us_per_call']:.2f} us per call, events {row['event_us']:.2f} / "
            f"{row['library_event_us']:.2f} us: "
            + ("no slower" if row["event_us"] <= row["library_event_us"] else "SLOWER")
            + " by the events, "
            + ("no slower" if row["device_us"] <= row["library_device_us"] else "SLOWER")
            + " on the device")

    # the scans: tolerance √S · epsilon · max|cs| per rep, same bits on two runs
    # and as the kernels' order restated (taa.scan_order_plain)
    ref64 = torch.cumsum(tab.double(), 0)
    got, want = taa.cumsum_probe(tab, reps), taa.cumsum_probe_plain(tab, reps)
    tol = taa.scan_tolerance(float(ref64.abs().max()), s, reps)
    err = float((got - want).abs().max())
    one = taa.cumsum_probe(tab, 1)
    log(f"  cumsum_cols: max_abs_err={err:.3e} tol={tol:.3e} (√S·eps·max|cs|·reps, max|cs| "
        f"{float(ref64.abs().max()):.1f}) {'ok' if err <= tol else 'FAIL'}; against an f64 "
        f"scan at reps 1: kernel {float((one - ref64).abs().max()):.3e}, torch.cumsum "
        f"{float((torch.cumsum(tab, 0) - ref64).abs().max()):.3e}")
    if not err <= tol or not torch.equal(got, taa.cumsum_probe(tab, reps)):
        raise AssertionError("cumsum_cols disagrees with its plain version or itself")
    _scan_order_check(tab, ids, coef, begin, end, reps)
    record("cumsum_cols", f"C [{s}x{taa.LANES}] f32 x{reps} reps", res["C"]["ms"],
           cuda_ms(lambda: taa.cumsum_probe_plain(tab, reps), 5),
           cuda_ms(lambda: torch.cumsum(tab, 0), 10), "cumsum (one scan, no repeats)",
           _bound(8 * elems, elems * (1 + reps)), err,
           (lambda: taa.cumsum_probe(tab, reps), lambda: torch.cumsum(tab, 0)), head=True)

    got = taa.piece_probe(ids, coef, begin, end, tab, reps)
    want = taa.piece_probe_plain(ids, coef, begin, end, tab, reps)
    cs_max = float(taa.piece_scan(ids, coef, tab).abs().max())
    tol = taa.scan_tolerance(cs_max, s, reps)
    err = float((got - want).abs().max())
    seg = taa.gather_segment_library(ids, coef, rows_sorted, tab)
    log(f"  piece: max_abs_err={err:.3e} tol={tol:.3e} (√S·eps·max|cs|·reps, max|cs| "
        f"{cs_max:.1f}) {'ok' if err <= tol else 'FAIL'}; against {reps} x the library's "
        f"gather and index_add_: {float((got - reps * seg).abs().max()):.3e}")
    if not err <= tol or not torch.equal(got, taa.piece_probe(ids, coef, begin, end, tab, reps)):
        raise AssertionError("piece disagrees with its plain version or itself")
    record("piece", f"D [{s}x{taa.LANES}] f32 x{reps} reps", res["D"]["ms"],
           cuda_ms(lambda: taa.piece_probe_plain(ids, coef, begin, end, tab, reps), 5),
           res["X"]["ms"], "index_select*coef + index_add_ (one piece)",
           _bound(16 * s + 8 * elems, elems * (3 + reps)), err,
           (lambda: taa.piece_probe(ids, coef, begin, end, tab, reps),
            lambda: taa.gather_segment_library(ids, coef, rows_sorted, tab)), head=True)
    for name in ("A2", "C", "D", "X"):
        log(f"    {name}: {res[name]['ms']:.4f} ms = {res[name]['ns_per_row']:.3f} ns/row "
            f"over {res[name]['rows']} rows")
    for kernel, row in _own_process_launches(f"_scan_trace({s}, {reps})").items():
        out[kernel].update(row)
    _scan_edges()
    return out


SCAN_TRACE_TRIES = 3


def _kernel_records(fn, idle_s: float = 0.0) -> dict:
    """{kernel name: [records, device us]} of the kernels that torch.profiler
    saw in ``PROFILED_CALLS`` calls of ``fn`` (no user annotations); the trace
    stops ``idle_s`` seconds after the card has finished them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(idle_s)
    out = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if (dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", ""))
                and not getattr(evt, "is_user_annotation", False)):
            out[evt.key] = [evt.count, dev_us]
    return out


def _traces(calls: dict) -> dict:
    """{kernel: [``_kernel_records`` of a trace, ...]} for each wrapper call of
    ``calls`` ({kernel: fn}): the traces taken, up to ``SCAN_TRACE_TRIES``,
    until one kept a whole number of records a call of every kernel."""
    import torch

    got = {}
    for kernel, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        got[kernel] = []
        while len(got[kernel]) < SCAN_TRACE_TRIES:
            got[kernel].append(_kernel_records(fn))
            if all(n % PROFILED_CALLS == 0 for n, _ in got[kernel][-1].values()):
                break
    return got


def _scan_trace(s: int, reps: int) -> None:
    """Prints, as one JSON line, ``_traces`` of each scan's wrapper on
    ``taa.make_inputs(s)``, ``reps`` reps. ``_own_process_launches`` runs it in
    a process of its own."""
    from cuda_gcn_torch.probes import taa

    x = taa.make_inputs(s, device="cuda")
    tab, ids, coef, begin, end = (x[k] for k in ("tab", "ids", "coef", "begin", "end"))
    print(json.dumps(_traces({
        "cumsum_cols": lambda: taa.cumsum_probe(tab, reps),
        "piece": lambda: taa.piece_probe(ids, coef, begin, end, tab, reps)})), flush=True)


def _scatter_trace() -> None:
    """Prints, as one JSON line, ``_traces`` of probe B's wrapper at the
    script's shape (``gather.run``'s inputs, seed 0)."""
    from cuda_gcn_torch.probes import gather as probes

    x = probes.make_inputs(16384, 1 << 20, 128, 0, "cuda")
    idx, coef, h = x["idx_sorted"], x["coef"], x["h"]
    print(json.dumps(_traces({"scatter_probe": lambda: probes.scatter_probe(
        idx, coef, h, probes.SCATTER_MAX)})), flush=True)


def _own_process_launches(call: str) -> dict:
    """The kernels that one call of each wrapper that ``chip_smoke.<call>``
    traces runs on the card, by name, from a profiler trace of
    ``PROFILED_CALLS`` calls taken in a process of its own (late in a full run
    a trace in this process has kept 12-14 of 20 records). Fails unless the
    last trace of each holds one kernel with exactly ``PROFILED_CALLS``
    records: one CUDA launch a call. Returns {kernel: {cuda_launches_per_call,
    trace_device_us}}, the device us a record of that trace."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
                         cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise AssertionError(f"the trace {call}: rc {res.returncode}\n{res.stderr[-4000:]}")
    out = {}
    for kernel, traces in json.loads(res.stdout.strip().splitlines()[-1]).items():
        for i, split in enumerate(traces):
            log(f"  {kernel}, trace {i + 1} of {PROFILED_CALLS} calls: "
                + "; ".join(f"{name}: {n} records, {us / max(n, 1):.2f} us each"
                            for name, (n, us) in split.items()))
        last = list(traces[-1].values())
        if len(last) != 1 or last[0][0] != PROFILED_CALLS:
            raise AssertionError(f"{kernel}: the last trace did not hold one kernel with "
                                 f"{PROFILED_CALLS} records in {PROFILED_CALLS} calls: "
                                 f"{traces[-1]}")
        log(f"  {kernel}: one CUDA launch a call")
        out[kernel] = {"cuda_launches_per_call": 1,
                       "trace_device_us": last[0][1] / PROFILED_CALLS}
    return out


def _scan_order_check(tab, ids, coef, begin, end, reps: int, label: str = "") -> None:
    """Both scan kernels equal, bit for bit, the order of additions that
    ``taa.scan_order_plain`` restates: the fixed order is what makes them
    repeat their bits."""
    import torch

    from cuda_gcn_torch.probes import taa

    s, l = tab.shape
    order = taa._repeat_add(taa.scan_order_plain(tab), reps)
    vals = tab[ids.reshape(-1).long()] * coef.reshape(-1, 1)
    cs = torch.cat([torch.zeros(1, l, device=tab.device), taa.scan_order_plain(vals)])
    piece = taa._repeat_add(cs[end.reshape(-1).long()] - cs[begin.reshape(-1).long()], reps)
    for kernel, got, want in (("cumsum_cols", taa.cumsum_probe(tab, reps), order),
                              ("piece", taa.piece_probe(ids, coef, begin, end, tab, reps),
                               piece)):
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {label}[{s}x{l}]: not the order of scan_order_plain "
                                 f"(max abs difference {float((got - want).abs().max()):.3e})")


# The scans off the scripts' shape: (S, L, reps, table 16-byte aligned). S of
# one row, less than a chunk of 128 and one past half of it, at widths of one
# value, 4 columns that are no whole 16-byte load, a tile less one, one tile,
# and one tile plus a part; past the rows the card holds at once (the chunk
# loop, in waves); tables off a 16-byte boundary (one value at a time).
SCAN_EDGES = tuple((s, l, 1 + 2 * (i % 2), True) for i, (s, l) in enumerate(
    [(s, l) for s in (1, 63, 65) for l in (1, 5, 127, 128, 333)])) + (
    ((1 << 20) + 3, 128, 3, True), (16384, 128, 3, False), (65, 333, 1, False))


def _scan_boundaries(s: int, rng):
    """begin and end in [0, S] in no order: empty segments (begin == end),
    whole scans (0, S), end == S on the last row, and begin > end."""
    begin = rng.integers(0, s + 1, s).astype("int32")
    end = rng.integers(0, s + 1, s).astype("int32")
    end[-1] = s
    begin[1::7], end[1::7] = 0, s
    end[::5] = begin[::5]
    return begin, end


def _scan_edges() -> None:
    """(j), ``SCAN_EDGES``: both scans within ``taa.scan_tolerance`` of their
    plain versions, the same bits on two calls and equal to the restated order."""
    import numpy as np
    import torch

    from cuda_gcn_torch.probes import taa

    rng = np.random.default_rng(13)
    for s, l, reps, aligned in SCAN_EDGES:
        buf = torch.empty(s * l + 4, device="cuda")
        tab = (buf[:s * l] if aligned else buf[1:1 + s * l]).view(s, l)
        tab.copy_(torch.from_numpy(rng.standard_normal((s, l), dtype=np.float32)))
        ids = torch.from_numpy(rng.integers(0, s, (s, 1), dtype=np.int32)).cuda()
        coef = torch.from_numpy(rng.random((s, 1), dtype=np.float32)).cuda()
        begin, end = (torch.from_numpy(a[:, None]).cuda() for a in _scan_boundaries(s, rng))
        errs = []
        for kernel, fn, plain, cs_max in (
                ("cumsum_cols", lambda: taa.cumsum_probe(tab, reps),
                 lambda: taa.cumsum_probe_plain(tab, reps),
                 lambda: float(torch.cumsum(tab.double(), 0).abs().max())),
                ("piece", lambda: taa.piece_probe(ids, coef, begin, end, tab, reps),
                 lambda: taa.piece_probe_plain(ids, coef, begin, end, tab, reps),
                 lambda: float(taa.piece_scan(ids, coef, tab).abs().max()))):
            got = fn()
            tol = taa.scan_tolerance(cs_max(), s, reps)
            err = float((got - plain()).abs().max())
            if not err <= tol or not torch.equal(got, fn()):
                raise AssertionError(f"{kernel} [{s}x{l}] x{reps} reps (table "
                                     f"{'aligned' if aligned else 'off 16 bytes'}): error "
                                     f"{err:.3e} against {tol:.3e}, or not the same bits twice")
            errs.append(f"{kernel} {err:.3e} (tol {tol:.3e})")
        _scan_order_check(tab, ids, coef, begin, end, reps, "edge ")
        log(f"  scans [{s}x{l}] x{reps} reps, table {'aligned' if aligned else 'off 16 bytes'}: "
            + ", ".join(errs) + "; the same bits twice and as scan_order_plain")


# taa_lanes' group form off the scripts' shapes: (S, L, dtype, steps, reps,
# table 16-byte aligned). Ragged row groups (S 17, 3, 5), rows that are no
# whole number of 16-byte loads (L 333) or a table off a 16-byte boundary,
# both staged one value at a time, and steps past and within a batch of 16.
LANE_EDGES = ((17, 333, "float32", 7, 1, True), (3, 333, "bfloat16", 5, 2, True),
              (3, 1000, "bfloat16", 9, 1, False), (17, 1000, "bfloat16", 20, 1, True),
              (5, 4096, "float32", 16, 1, False))


def _lanes_edges() -> None:
    """(j), ``LANE_EDGES``: each case in the group form, equal bit for bit to
    its plain version."""
    import numpy as np
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.probes import taa

    rng = np.random.default_rng(12)
    for s, l, dtype, steps, reps, aligned in LANE_EDGES:
        dt = getattr(torch, dtype)
        vals = torch.from_numpy(rng.standard_normal((s, l), dtype=np.float32)).to(dt)
        buf = torch.empty(s * l + 8, dtype=dt, device="cuda")
        tab = buf[:s * l] if aligned else buf[1:1 + s * l]
        tab = tab.view(s, l)
        tab.copy_(vals)
        idx = torch.from_numpy(rng.integers(0, l, steps * l, dtype=np.int32)).cuda()
        strides = (0, 1, l)
        form = kernels.taa_lanes_form(strides, s, l, steps, tab.element_size())
        staged = ("16-byte loads" if l % (16 // tab.element_size()) == 0
                  and tab.data_ptr() % 16 == 0 else "one value at a time")
        got = kernels.taa_lanes(idx, strides, tab, steps, reps)
        want = taa.taa_lanes_plain(idx, strides, tab, steps, reps)
        ok = form.form == "group" and torch.equal(got, want)
        log(f"  taa_lanes [{s}x{l}] {dtype} x{steps} steps x{reps} reps: {form.form} form, "
            f"{form.rows} rows a CTA, tile {form.tile}, staged by {staged}: "
            f"{'equal' if ok else 'FAIL'} to its plain version")
        if not ok:
            raise AssertionError(f"taa_lanes [{s}x{l}] {dtype}: not the group form, or not "
                                 f"equal to its plain version")


def _mass_check(name, got, want, mass):
    """A sum of many products: the error is held to 1e-6 of the sum of the
    terms' magnitudes (about 8 f32 epsilons of it), as for the gather probe."""
    err = float((got - want).abs().max())
    ratio = float(((got - want).abs() / (1e-6 * mass + 1e-12)).max())
    log(f"  {name}: max_abs_err={err:.3e} max_err/tol={ratio:.3f} (tol 1e-6 * sum |v*w|) "
        f"{'ok' if ratio <= 1 else 'FAIL'}")
    if not ratio <= 1:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def phase_sparse_kernels(dataset, label: str = "(k)"):
    """(k), first half: the layer-0 products on synth-reddit's features."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.ops import matmul as mm

    t0 = time.perf_counter()
    x = _features(dataset, sparse=True)
    torch.cuda.synchronize()
    n, f, nnz = x.n_rows, x.n_cols, x.nnz
    per_col = torch.diff(x.t_ptr.long()).float()
    log(f"{label} sparse layer-0: features [{n}, {f}] nnz={nnz} ({nnz / n:.1f} per row; per "
        f"column mean {per_col.mean():.0f} max {per_col.max():.0f}) on the card in "
        f"{time.perf_counter() - t0:.2f} s; dW work list {x.t_work.beg.numel()} items, "
        f"{x.t_work.n_partials} partials")
    gen = torch.Generator(device="cuda").manual_seed(4)
    xd = _features(dataset, sparse=False)
    a_lib = torch.sparse_csr_tensor(x.row_ptr.long(), x.cols.long(), x.values, size=(n, f))
    vals_abs = x.values.abs()
    out = {"forward": {}, "dw": {}}
    for d in (16, 32):
        w = torch.randn(f, d, generator=gen, device="cuda")
        got = mm.csr_matmul(x.values, x, w)
        want = mm.csr_matmul_plain(x.values, x.rows, x.cols, w, n)
        mass = mm.csr_matmul_plain(vals_abs, x.rows, x.cols, w.abs(), n)
        err = _mass_check(f"csr_matmul forward d={d}", got, want, mass)
        if not torch.equal(got, mm.csr_matmul(x.values, x, w)):
            raise AssertionError("the sparse forward differs between two runs")
        ms = cuda_ms(lambda: mm.csr_matmul(x.values, x, w), 20)
        plain = cuda_ms(lambda: mm.csr_matmul_plain(x.values, x.rows, x.cols, w, n), 5)
        lib = cuda_ms(lambda: a_lib @ w, 10)
        blas = cuda_ms(lambda: xd @ w, 10)
        bound, by = _bound(8 * nnz + 4 * (n + 1) + 4 * f * d + 4 * n * d, 2 * nnz * d)
        log(f"  forward d={d}: csr_spmm {ms:.4f} ms (plain {plain:.4f}; sparse CSR library "
            f"{lib:.4f}; cuBLAS x @ W on dense x {blas:.4f}; bound {bound:.4f} ms, {by})")
        out["forward"][str(d)] = dict(ms=ms, plain_ms=plain, library_ms=lib, cublas_dense_ms=blas,
                                      bound_ms=bound, bound_by=by, max_abs_err=err)
    d = 16
    g = torch.randn(n, d, generator=gen, device="cuda")
    got = mm.csr_matmul_dw(x, x.values, g)
    t_vals = x.values[x.t_perm]
    t_cols = x.cols[x.t_perm]
    want = mm.csr_matmul_plain(t_vals, t_cols, x.t_rows, g, f)
    mass = mm.csr_matmul_plain(t_vals.abs(), t_cols, x.t_rows, g.abs(), f)
    err = _mass_check(f"csr_matmul dW d={d}", got, want, mass)
    if not torch.equal(got, mm.csr_matmul_dw(x, x.values, g)):
        raise AssertionError("the sparse dW differs between two runs")
    # autograd reaches the same kernels, and gives the gradient for the values
    w = torch.randn(f, d, generator=gen, device="cuda", requires_grad=True)
    v = x.values.clone().requires_grad_(True)
    mm.csr_matmul(v, x, w).backward(g)
    want_v = (w.detach()[x.cols.long()] * g[x.rows.long()]).sum(1)
    if not torch.equal(w.grad, got) or not torch.allclose(v.grad, want_v, rtol=1e-5, atol=1e-6):
        raise AssertionError("csr_matmul's backward disagrees with its kernels")
    t = x.t_work
    ms = cuda_ms(lambda: mm.csr_matmul_dw(x, x.values, g), 20)
    k3 = cuda_ms(lambda: kernels.ell_spmm(t.beg, t.len, t.dst, t.split_rows, t.split_ptr,
                                          x.t_rows, t_vals, g, f, t.n_partials), 20)
    via2 = kernels.csr_spmm(t, x.t_rows, t_vals, g, f)
    _mass_check(f"dW through kernel 2 d={d}", via2, want, mass)
    k2 = cuda_ms(lambda: kernels.csr_spmm(t, x.t_rows, t_vals, g, f), 10)
    plain = cuda_ms(lambda: mm.csr_matmul_plain(t_vals, t_cols, x.t_rows, g, f), 5)
    a_t = torch.sparse_csr_tensor(x.t_ptr.long(), x.t_rows.long(), t_vals, size=(f, n))
    lib = cuda_ms(lambda: a_t @ g, 10)
    blas = cuda_ms(lambda: xd.t() @ g, 10)
    bound, by = _bound(16 * nnz + 4 * (f + 1) + 4 * n * d + 4 * f * d, 2 * nnz * d)
    log(f"  dW d={d}: values[t_perm] + kernel 3 {ms:.4f} ms (kernel 3 alone {k3:.4f}; "
        f"through kernel 2 {k2:.4f}; plain {plain:.4f}; sparse CSR library {lib:.4f}; cuBLAS "
        f"x.T @ g on dense x {blas:.4f}; bound {bound:.4f} ms, {by})")
    out["dw"][str(d)] = dict(ms=ms, kernel3_alone_ms=k3, through_kernel2_ms=k2, plain_ms=plain,
                             library_ms=lib, cublas_dense_ms=blas, bound_ms=bound, bound_by=by,
                             max_abs_err=err)
    return out


def phase_sparse_path(dataset):
    """(k), second half: training with feature_matmul='sparse'."""
    import dataclasses

    import numpy as np

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached, reorder_cached

    cfg = GCNConfig(epochs=EPOCHS, graphsum_backend="bsr", reorder="none", seed=0,
                    feature_matmul="sparse")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = train.run(cfg, dataset, device="cuda", verbose=False)
    launches = dict(kernels.launches)
    losses = [h["train_loss"] for h in res.history]
    log(f"  train.run synth-reddit sparse features, bsr, dropout {cfg.dropout}, {EPOCHS} "
        f"epochs: {time.perf_counter() - t0:.1f} s (graph build included); train loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}, test_acc {res.test_acc:.5f}")
    if not np.isfinite(_metrics(res)).all() or not losses[-1] < losses[0]:
        raise AssertionError("the sparse-feature run did not train")
    # per epoch: 4 adjacency passes (kernels 1 and 2 each), the layer-0 product of
    # the train and the eval half (kernel 2 twice), one dW (kernel 3); each of the
    # trailing and the test eval: 2 adjacency passes and one layer-0 product
    expected = {"bsr_tile": 4 * EPOCHS + 4, "csr_spmm": 6 * EPOCHS + 6, "ell_spmm": EPOCHS}
    log(f"  launches {launches}; expected {expected}, 0 for the others")
    if any(v != expected.get(k, 0) for k, v in launches.items()):
        raise AssertionError("the sparse path's launch counts are not what the code should make")

    zero = dataclasses.replace(cfg, epochs=3, dropout=0.0)
    a, b = (_metrics(train.run(dataclasses.replace(zero, feature_matmul=fm), dataset,
                               device="cuda", verbose=False)) for fm in ("sparse", "dense"))
    diff = float(np.abs(a - b).max())
    log(f"  sparse vs dense features, 3 epochs at dropout 0, same weights: max metric diff "
        f"{diff:.3e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"sparse and dense features disagree:\n{a}\n{b}")

    ds = reorder_cached(load_cached("synth-pubmed"), "synth-pubmed")
    a, b = (_metrics(train.run(zero, ds, device=dev, verbose=False)) for dev in ("cuda", "cpu"))
    diff = float(np.abs(a - b).max())
    log(f"  synth-pubmed sparse features, 3 epochs, card vs CPU plain versions: max metric "
        f"diff {diff:.3e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU disagree on sparse synth-pubmed:\n{a}\n{b}")
    return launches


TEXT_EPOCHS = 5


def phase_text_entry():
    import contextlib
    import io
    import os
    import re
    import tempfile

    import numpy as np

    from cuda_gcn_torch import cli, kernels
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.data.parser import load_dataset

    ds = load_cached("synth-cora")
    g, fi = ds.graph, ds.feature_index
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cora-text.graph"), "w") as fh:
            for i in range(ds.num_nodes):  # without the self-loop: the parser puts it first
                row = g.indices[g.indptr[i]:g.indptr[i + 1]]
                fh.write(" ".join(str(j) for j in row if j != i) + "\n")
        with open(os.path.join(tmp, "cora-text.split"), "w") as fh:
            fh.write("\n".join(str(int(v)) for v in ds.split) + "\n")
        with open(os.path.join(tmp, "cora-text.svmlight"), "w") as fh:
            for i in range(ds.num_nodes):
                lo, hi = fi.indptr[i], fi.indptr[i + 1]
                kvs = " ".join(f"{int(k)}:{float(v):.9g}" for k, v in
                               zip(fi.indices[lo:hi], ds.feature_value[lo:hi]))
                fh.write(f"{int(ds.label[i])} {kvs}".rstrip() + "\n")
        parsed = load_dataset("cora-text", data_dir=tmp)
        for a, b, what in ((parsed.graph.indptr, g.indptr, "graph.indptr"),
                           (parsed.graph.indices, g.indices, "graph.indices"),
                           (parsed.feature_index.indptr, fi.indptr, "feature indptr"),
                           (parsed.feature_index.indices, fi.indices, "feature indices"),
                           (parsed.feature_value, ds.feature_value, "feature values"),
                           (parsed.label, ds.label, "label"), (parsed.split, ds.split, "split")):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"the parsed {what} differs from the cached dataset")
        if (parsed.num_nodes, parsed.input_dim, parsed.output_dim) != (
                ds.num_nodes, ds.input_dim, ds.output_dim):
            raise AssertionError("the parsed dims differ from the cached dataset")
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["cora-text", "--data-dir", tmp, "--feature-matmul", "sparse",
                           "--epochs", str(TEXT_EPOCHS)])
        missing = cli.main(["cora-text-missing", "--data-dir", tmp])
    launches = dict(kernels.launches)
    lines = buf.getvalue().strip().splitlines()
    log(f"(l) text entry point: cora-text parsed equal to synth-cora ({ds.num_nodes} nodes, "
        f"{g.nnz} edges, {fi.nnz} feature nnz); cli.main rc {rc}, a missing name rc {missing}")
    for line in lines:
        log("  | " + line)
    num = r"-?\d+\.\d{5}"
    head = ["Parse Graph Succeeded.", "Parse Node Succeeded.", "Parse Split Succeeded.",
            "RUNNING ON CUDA"]
    ok = rc == 0 and missing == 1 and lines[:4] == head and len(lines) == 4 + TEXT_EPOCHS + 2
    for i, line in enumerate(lines[4:4 + TEXT_EPOCHS], start=1):
        ok = ok and re.fullmatch(rf"epoch={i} train_loss={num} train_acc={num} "
                                 rf"val_loss={num} val_acc={num} time={num}", line)
    ok = ok and re.fullmatch(rf"total training time={num}", lines[-2]) \
        and re.fullmatch(rf"test_loss={num} test_acc={num} time={num}", lines[-1])
    if not ok:
        raise AssertionError("the text entry point's output is not the reference's format")
    # dense backend at 2,708 nodes: only the layer-0 kernels launch. Per epoch the
    # train and the eval product (kernel 2) and one dW (kernel 3); one product for
    # each of the trailing and the test eval
    expected = {"csr_spmm": 2 * TEXT_EPOCHS + 2, "ell_spmm": TEXT_EPOCHS}
    log(f"  launches {launches}; expected {expected}, 0 for the others")
    if any(v != expected.get(k, 0) for k, v in launches.items()):
        raise AssertionError("the text run's layer-0 did not go through the kernels")
    return launches


# (m) bf16 activations and weights at full width


def _ulp_bf16(x):
    """One bf16 ulp of each element of the f32 tensor x: 2^(e - 8) where |x| =
    m·2^e with m in [0.5, 1) (bf16 keeps 8 significant bits); 0 where x is 0."""
    import torch

    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x), torch.ldexp(torch.ones_like(x), e - 8))


BF16_ORDER = 1e-6  # the f32 accumulation-order term, a share of the sum of the terms' magnitudes


def check_bf16(name: str, got, want, mass) -> float:
    """bf16 outputs of a kernel and of its plain version, both summed in f32 and
    rounded once: per element within one bf16 ulp (the two f32 sums may round
    to neighbours; the ulp of the larger of the two, since neighbours may lie
    on either side of a power of two) plus ``BF16_ORDER`` of the sum of the
    terms' magnitudes ``mass`` (the f32 sums' different orders)."""
    import torch

    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: expected bf16 outputs, got {got.dtype} and {want.dtype}")
    err = (got.float() - want.float()).abs()
    tol = _ulp_bf16(torch.maximum(got.float().abs(), want.float().abs())) + BF16_ORDER * mass
    ratio = float((err / tol.clamp_min(1e-30)).max())
    ok = ratio <= 1.0
    log(f"  {name}: max_abs_err={float(err.max()):.3e} max_err/tol={ratio:.3f} (one bf16 ulp "
        f"+ {BF16_ORDER} x sum of |terms|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at bf16")
    return float(err.max())


def _bf16_kernels(graph, plan, ell_csr, errs):
    """(m): kernels 1, 2 (both forms) and 3 at bf16 h on synth-reddit, at the
    main path's widths: each against its plain version and bitwise repeatable,
    then timed beside its plain version, its bytes bound at bf16 and the
    library's call (None where the library refuses bf16; ``ell_csr`` is the
    ELL graph's adjacency as a bf16 sparse CSR tensor). Returns {name: {d:
    row}}."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, bsr_tile_contract_plain, tile_plan
    from cuda_gcn_torch.ops.ell import ell_spmm, ell_spmm_plain
    from cuda_gcn_torch.ops.residual import residual_spmm, residual_spmm_plain

    bf16 = torch.bfloat16
    n, k, tb, t_blocks = graph.n_nodes, graph.num_tiles, graph.tb, graph.t_blocks
    r = graph.resid
    if r.coef.dtype != bf16 or plan.coef.dtype != bf16:
        raise AssertionError("a graph built for bf16 activations must hold bf16 coefficients")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tile_bytes = graph.tiles.numel() * graph.tiles.element_size()
    csr = torch.sparse_csr_tensor(r.row_ptr.long(), r.cols.long(), r.coef, size=(n, n))
    plan_t = tile_plan(graph.tile_cols, graph.tile_rows, t_blocks)
    out = {"bsr_tile": {}, "csr_spmm": {}, "ell_spmm": {}}
    log(f"(m) bf16 kernels on synth-reddit: K={k} bf16 tiles, residual nnz={r.nnz} (bf16 "
        f"coefficients), ELL nnz={plan.nnz}; tolerance per element: one bf16 ulp (of the larger "
        f"of kernel and plain value) + {BF16_ORDER} x sum of |terms|")
    for d in WIDTHS:
        h = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
        habs = h.float().abs()
        for transpose in (False, True):
            rows, cols, tplan = ((graph.tile_cols, graph.tile_rows, plan_t) if transpose
                                 else (graph.tile_rows, graph.tile_cols, graph.plan))

            def tile_part():
                return bsr_tile_contract(graph.tiles, rows, cols, h, n, t_blocks,
                                         transpose=transpose, plan=tplan)

            got = tile_part()
            want = bsr_tile_contract_plain(graph.tiles, rows, cols, h, n, t_blocks, transpose)
            mass = bsr_tile_contract_plain(graph.tiles, rows, cols, habs, n, t_blocks, transpose)
            errs["bsr_tile_bf16"] = max(errs.get("bsr_tile_bf16", 0.0), check_bf16(
                f"bsr_tile bf16 d={d} transpose={transpose}", got, want, mass))
            if not torch.equal(got, tile_part()):
                raise AssertionError(f"bsr_tile bf16 d={d} differs between two runs")
        rmass = residual_spmm_plain(r.row_ptr, r.cols, r.coef.float(), habs)
        got = residual_spmm(r.row_ptr, r.cols, r.coef, h, work=r.work)
        errs["csr_spmm_bf16"] = max(errs.get("csr_spmm_bf16", 0.0), check_bf16(
            f"csr_spmm bf16 d={d}", got, residual_spmm_plain(r.row_ptr, r.cols, r.coef, h), rmass))
        base = torch.randn(n, d, generator=gen, device="cuda").to(bf16)
        got2 = residual_spmm(r.row_ptr, r.cols, r.coef, h, out=base.clone(), work=r.work)
        want2 = residual_spmm_plain(r.row_ptr, r.cols, r.coef, h, out=base.clone())
        errs["csr_spmm_bf16"] = max(errs["csr_spmm_bf16"], check_bf16(
            f"csr_spmm bf16 d={d} accumulate", got2, want2, rmass + base.float().abs()))
        got3 = ell_spmm(plan, h)
        errs["ell_spmm_bf16"] = max(errs.get("ell_spmm_bf16", 0.0), check_bf16(
            f"ell_spmm bf16 d={d}", got3, ell_spmm_plain(plan, h), ell_spmm_plain(plan, habs)))
        if not torch.equal(got, residual_spmm(r.row_ptr, r.cols, r.coef, h, work=r.work)) \
                or not torch.equal(got3, ell_spmm(plan, h)):
            raise AssertionError(f"kernel 2 or 3 at bf16 d={d} differs between two runs")

        # times at bf16 (CUDA events, warm), bounds: each input read once and
        # each output written once, h and out at 2 bytes a value
        t1 = cuda_ms(lambda: bsr_tile_contract(graph.tiles, graph.tile_rows, graph.tile_cols,
                                               h, n, t_blocks, plan=graph.plan), 20)
        p1 = cuda_ms(lambda: _bsr_plain(graph, graph.tile_rows, graph.tile_cols, h, False), 3)
        acc = torch.zeros(n, d, device="cuda", dtype=bf16)
        t2 = cuda_ms(lambda: residual_spmm(r.row_ptr, r.cols, r.coef, h, out=acc,
                                           work=r.work), 20)
        t2_new = cuda_ms(lambda: residual_spmm(r.row_ptr, r.cols, r.coef, h, work=r.work), 20)
        p2 = cuda_ms(lambda: residual_spmm_plain(r.row_ptr, r.cols, r.coef, h, out=acc), 5)
        t3 = cuda_ms(lambda: ell_spmm(plan, h), 20)
        p3 = cuda_ms(lambda: ell_spmm_plain(plan, h), 3)
        l2, note2 = _library_ms(lambda: (lambda: csr @ h), 20)
        width = kernels.bsr_mma_width(graph.tiles.dtype, tb, k, d, bf16)
        b1 = (_bound_at(tile_bytes + 4 * (2 * k + 2 * t_blocks + 1) + 2 * n * d + 2 * n * d,
                        2 * k * tb * tb * width / PEAK_BF16_FLOPS if width is not None
                        else 2 * k * tb * tb * d / PEAK_F32_FLOPS))
        b2 = _bound_at(12 * r.work.beg.numel() + 6 * r.nnz + 2 * n * d + 2 * 2 * n * d,
                       2 * r.nnz * d / PEAK_F32_FLOPS)
        b3 = _bound_at(6 * plan.nnz + 4 * n + 2 * n * d + 2 * n * d,
                       2 * plan.nnz * d / PEAK_F32_FLOPS)
        for name, ms, plain, bound in (("bsr_tile", t1, p1, b1), ("csr_spmm", t2, p2, b2),
                                       ("ell_spmm", t3, p3, b3)):
            out[name][d] = dict(ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                                bound_bytes_ms=bound[2], bound_operations_ms=bound[3])
        out["csr_spmm"][d].update(new_out_ms=t2_new, library_ms=l2,
                                  library_note=note2 or "sparse CSR (bf16 values) @ bf16 h")
        out["bsr_tile"][d]["accumulator_width"] = width
        gather_bytes = plan.nnz * 2 * d
        out["ell_spmm"][d].update(gather_no_reuse_ms=gather_bytes / PEAK_BYTES_PER_S * 1e3,
                                  gather_tb_per_s=gather_bytes / t3 / 1e9)
        log(f"  d={d} bf16: bsr_tile {t1:.3f} ms (N={width}, one bf16 plane; plain {p1:.3f}; "
            f"bound {b1[0]:.3f} ms by {b1[1]}: bytes {b1[2]:.3f}, operations {b1[3]:.3f}); "
            f"csr_spmm adding {t2:.3f} ms, new {t2_new:.3f} (plain {p2:.3f}; library sparse "
            f"CSR @ dense {_fmt_ms(l2)}{' (' + note2 + ')' if note2 else ''}; bound "
            f"{b2[0]:.4f} by {b2[1]}); ell_spmm {t3:.4f} ms (plain {p3:.3f}; bound {b3[0]:.4f} "
            f"by {b3[1]}; gathered at {out['ell_spmm'][d]['gather_tb_per_s']:.2f} TB/s)")
    d = WIDTHS[-1]
    h = torch.randn(n, d, generator=gen, device="cuda").to(bf16)

    def bsr_lib():
        a = torch.sparse_bsr_tensor(graph.plan.ptr.long(), graph.tile_cols.long(),
                                    graph.tiles, size=(t_blocks * tb, t_blocks * tb))
        hp = torch.zeros(t_blocks * tb, d, device="cuda", dtype=bf16)
        hp[:n] = h
        return lambda: a @ hp

    l1, note1 = _library_ms(bsr_lib, 3)
    out["bsr_tile"][d].update(library_ms=l1, library_note=note1 or
                              "sparse BSR (bf16 tiles) @ bf16 dense")
    l3, note3 = _library_ms(lambda: (lambda: ell_csr @ h), 10)
    out["ell_spmm"][d].update(library_ms=l3, library_note=note3 or
                              "sparse CSR (bf16 values) @ bf16 h")
    log(f"  library at d={d}, bf16: sparse BSR @ dense {_fmt_ms(l1)}"
        f"{' (' + note1 + ')' if note1 else ''}; sparse CSR @ dense over the ELL graph "
        f"{_fmt_ms(l3)}{' (' + note3 + ')' if note3 else ''}")
    return out


def _bound_at(nbytes: float, op_s: float):
    """(bound ms, 'bytes' or 'operations', bytes ms, operations ms) for a byte
    count and an operation time in seconds."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = op_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def _bf16_run(dataset, backend: str, epochs: int, expected: dict, label: str, **dtypes):
    """``train.run`` at bf16 with the launch counts set to 0 just before and read
    just after: finite metrics, a falling train loss, and each kernel of the
    path launched as often as the code should make it."""
    import numpy as np

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig

    cfg = GCNConfig(epochs=epochs, graphsum_backend=backend, reorder="none", seed=0, **dtypes)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = train.run(cfg, dataset, device="cuda", verbose=False)
    launches = dict(kernels.launches)
    losses = [h["train_loss"] for h in res.history]
    log(f"  train.run {label}: {time.perf_counter() - t0:.1f} s (graph build included), "
        f"train loss {losses[0]:.5f} -> {losses[-1]:.5f}, test_acc {res.test_acc:.5f}; "
        f"launches {launches}, expected {expected}, 0 for the others")
    if not np.isfinite(_metrics(res)).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the bf16 run ({label}) did not train")
    if any(v != expected.get(k, 0) for k, v in launches.items()):
        raise AssertionError(f"the bf16 run ({label}) did not go through its kernels")
    return launches


def _bf16_layer0(dataset):
    """The dense layer 0 at compute bf16, param f32: the port's bf16 GEMM on W
    rounded to bf16 against the JAX package's form, an f32 product of bf16 x
    and f32 W rounded to bf16, on synth-reddit's features; error in bf16 ulps
    of the JAX form's value and times of both forms."""
    import torch

    from cuda_gcn_torch.ops.matmul import dense_matmul

    x = _features(dataset, False, torch.bfloat16)
    w = torch.randn(dataset.input_dim, 16, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda") * (6.0 / (dataset.input_dim + 16)) ** 0.5
    got = dense_matmul(x, w)
    want = (x.float() @ w).to(torch.bfloat16)
    err = (got.float() - want.float()).abs()
    scale = x.float().abs() @ w.abs()
    # in units of bf16's rounding error 2^-8 of sum |x||w|: W's rounding, and
    # each form's own rounding of its result, are at most one unit each
    units = float((err / scale.clamp_min(1e-30)).max()) / 2.0 ** -8
    t_port = cuda_ms(lambda: dense_matmul(x, w), 20)
    t_jax = cuda_ms(lambda: (x.float() @ w).to(torch.bfloat16), 20)
    log(f"  dense layer 0 at bf16 x, f32 W, [{x.shape[0]}, {x.shape[1]}] x [{w.shape[0]}, 16]: "
        f"the port's bf16 GEMM on bf16-rounded W against the JAX form (f32 product of bf16 x, "
        f"rounded): max error {float(err.max()):.3e}, {units:.2f} x 2^-8 of sum |x||w| (limit "
        f"3: W's rounding and the two results'); {t_port:.4f} ms against {t_jax:.4f} ms for "
        f"the JAX form")
    if not units <= 3.0:
        raise AssertionError("the bf16 layer-0 GEMM is further from the JAX form than its roundings")
    return dict(max_abs_err=float(err.max()), max_err_units=units, ms=t_port, jax_form_ms=t_jax)


def phase_bf16(dataset, errs):
    """(m): bf16 activations and weights at full width on synth-reddit
    (602-16-41): the kernels at bf16 against their plain versions and timed;
    the main path (bsr) and the ell path at compute_dtype='bfloat16', 10 fused
    epochs each with their profile; a param_dtype='bfloat16' run; synth-pubmed
    at bf16 against the CPU; the seeded CLI."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from cuda_gcn_torch import cli, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached, reorder_cached
    from cuda_gcn_torch.data.graph import build_graph, normalization_coefficients

    bf = dict(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    graph = build_graph(dataset.graph, backend="bsr", act_itemsize=2, device="cuda")
    raw = load_cached("synth-reddit")
    ell_graph = build_graph(raw.graph, backend="ell", act_itemsize=2, device="cuda")
    torch.cuda.synchronize()
    log(f"(m) bf16: bsr graph (relabelled) and ell graph (as loaded) of synth-reddit built for "
        f"bf16 activations in {time.perf_counter() - t0:.1f} s")
    indptr, indices = (a.astype(np.int64) for a in (raw.graph.indptr, raw.graph.indices))
    ell_csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr).cuda(), torch.from_numpy(indices).cuda(),
        torch.from_numpy(normalization_coefficients(indptr, indices)).cuda().to(torch.bfloat16),
        size=(raw.num_nodes, raw.num_nodes))
    timing = _bf16_kernels(graph, ell_graph.ell, ell_csr, errs)
    del ell_csr
    layer0 = _bf16_layer0(dataset)

    epoch = {}
    epoch["bsr"] = phase_steady(graph, dataset, " (synth-reddit, bsr, compute bf16)", **bf)
    prof = {"bsr": phase_profile(graph, dataset, label="  bsr at bf16,", **bf)}
    epoch["bsr, param bf16"] = phase_steady(
        graph, dataset, " (synth-reddit, bsr, compute and param bf16)",
        compute_dtype="bfloat16", param_dtype="bfloat16")
    del graph
    epoch["ell"] = phase_steady(ell_graph, raw, " (synth-reddit as loaded, ell, compute bf16)",
                                **bf)
    prof["ell"] = phase_profile(ell_graph, raw, label="  ell at bf16,", **bf)
    del ell_graph
    torch.cuda.empty_cache()

    bsr = {"bsr_tile": 4 * EPOCHS + 4, "csr_spmm": 4 * EPOCHS + 4, "layer0_pair": EPOCHS}
    launches = {"bsr": _bf16_run(dataset, "bsr", EPOCHS, bsr, "synth-reddit bsr, compute bf16",
                                 **bf)}
    _bf16_run(dataset, "bsr", EPOCHS, bsr, "synth-reddit bsr, compute and param bf16",
              compute_dtype="bfloat16", param_dtype="bfloat16")
    launches["ell"] = _bf16_run(raw, "ell", REDDIT_ELL_EPOCHS,
                                {"ell_spmm": 4 * REDDIT_ELL_EPOCHS + 4,
                                 "layer0_pair": REDDIT_ELL_EPOCHS},
                                "synth-reddit ell, compute bf16", **bf)
    del raw

    # synth-pubmed at bf16: the card's metrics against the CPU plain versions
    ds = reorder_cached(load_cached("synth-pubmed"), "synth-pubmed")
    worst = {}
    for params in ("float32", "bfloat16"):
        cfg = GCNConfig(epochs=3, dropout=0.0, graphsum_backend="bsr", reorder="none",
                        compute_dtype="bfloat16", param_dtype=params)
        a, b = (_metrics(train.run(cfg, ds, device=dev, verbose=False)) for dev in ("cuda", "cpu"))
        # the test row holds (test loss, test acc, 0, 0): its second "loss" is 0
        loss = np.abs(a[:, [0, 2]] - b[:, [0, 2]]) / np.maximum(np.abs(b[:, [0, 2]]), 1e-30)
        counts = [int((ds.split == s).sum()) for s in (1, 2)]
        nodes = np.abs(a[:-1, [1, 3]] - b[:-1, [1, 3]]) * counts
        test_nodes = abs(a[-1, 1] - b[-1, 1]) * int((ds.split == 3).sum())
        worst[params] = (float(loss.max()), float(max(nodes.max(), test_nodes)))
        log(f"  synth-pubmed bf16 (param {params}), 3 epochs at dropout 0, card vs CPU plain "
            f"versions: loss max rel diff {worst[params][0]:.3e} (tolerance 5e-3), accuracy "
            f"at most {worst[params][1]:.1f} nodes apart (tolerance 2)")
        if not worst[params][0] <= 5e-3 or not worst[params][1] <= 2.0 + 1e-6:
            raise AssertionError(f"card and CPU disagree on synth-pubmed at bf16:\n{a}\n{b}")

    # the seeded CLI: synth-cora generated at seed 3 on the card
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["synth-cora", "--seed", "3", "--epochs", "3"])
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log("  | " + line)
    num = r"-?\d+\.\d{5}"
    ok = rc == 0 and lines[:2] == ["Generated synthetic dataset synth-cora.", "RUNNING ON CUDA"] \
        and len(lines) == 2 + 3 + 2 and re.fullmatch(rf"test_loss={num} test_acc={num} "
                                                     rf"time={num}", lines[-1])
    if not ok:
        raise AssertionError("the seeded CLI run did not generate and train synth-cora")
    return dict(timing=timing, errs=errs, epoch_ms=epoch, profile=prof, launches=launches,
                layer0=layer0, pubmed=worst)


def _bf16_kernel_lines(m) -> list[dict]:
    """The bf16 variants of kernels 1-3 for the kernels line, at d = 82."""
    d = WIDTHS[-1]
    rows = []
    for name, replaces, launches in (
            ("bsr_tile", "cuda_gcn_tpu/ops/pallas_bsr.py:65 (+ :120 _bsr_kernel_resident), "
                         "bf16 h", m["launches"]["bsr"]["bsr_tile"]),
            ("csr_spmm", "cuda_gcn_tpu/ops/graphsum.py:136 (XLA _blocked2d_apply, not Pallas), "
                         "bf16 h", m["launches"]["bsr"]["csr_spmm"]),
            ("ell_spmm", "cuda_gcn_tpu/ops/pallas_spmm.py:67 (_ell_kernel), bf16 h",
             m["launches"]["ell"]["ell_spmm"])):
        row = m["timing"][name][d]
        rows.append({
            "name": f"{name}_bf16", "route": "cuda", "source": f"cuda_gcn_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": m["errs"][f"{name}_bf16"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "library_note": row.get("library_note"), "d": d, "dtype": "bfloat16",
            "by_width": {str(w): v for w, v in m["timing"][name].items()}})
    rows[0]["epoch_ms"] = m["epoch_ms"]
    rows[0]["profile"] = m["profile"]
    rows[0]["layer0_dense"] = m["layer0"]
    return rows


# (n) synth-reddit4x at full width, and (o) the CLI's extras

REDDIT4X_EPOCHS = 5
EPOCH_TOL = dict(rtol=1e-4, atol=1e-5)  # the JAX package's, tests/test_model.py:126-157


def _host_gb() -> float:
    """The process's peak resident host memory so far, GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _counted(label: str, fn, expected: dict) -> dict:
    """Run ``fn`` with every launch count set to 0 first; the counts must be
    ``expected`` (0 for a kernel not named)."""
    from cuda_gcn_torch import kernels

    kernels.reset_launches()
    fn()
    launches = dict(kernels.launches)
    log(f"  launches {launches}; expected {expected}, 0 for the others")
    if any(v != expected.get(k, 0) for k, v in launches.items()):
        raise AssertionError(f"{label}: the launch counts are not what the code should make")
    return launches


def phase_reddit4x(errs):
    """(n) synth-reddit4x (931,860 nodes, 602-16-41): the dataset generated by
    the port with seed 0, relabelled by the native LPA (numpy's LPA run beside
    it in the same call: time, labels bit for bit), built as the bsr graph by
    numpy's build steps (timed, dropped) and then the native ones, each step's
    host seconds and peak host memory; kernels 1 and 2 against their
    plain versions and timed at d 16/32/41/82 beside their bounds and the
    library; the dense-feature fused loop (steady ms/epoch, profile, peak
    device memory, launches); sparse features: kernels 2 (X·W) and 3 (dW)
    against their plain versions and timed, 3 epochs at dropout 0 against
    dense features within rtol 1e-4 / atol 1e-5, the steady sparse loop; the
    dense loop on the graph built for the ``segment`` backend."""
    import dataclasses

    import numpy as np
    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data import graph as graph_mod
    from cuda_gcn_torch.data.graph import build_graph
    from cuda_gcn_torch.data.reorder import cluster_order, label_propagation, reorder_dataset
    from cuda_gcn_torch.data.synthetic import make_synthetic

    name = "synth-reddit4x"
    setup = {}
    t0 = time.perf_counter()
    ds = make_synthetic(name, seed=0)
    setup["generate_s"] = time.perf_counter() - t0
    log(f"(n) {name}: generated in {setup['generate_s']:.1f} s (host peak {_host_gb():.1f} GB): "
        f"{ds.num_nodes} nodes, {ds.graph.nnz} edges with self-loops, "
        f"{len(ds.feature_value)} feature nnz, {ds.input_dim}-16-{ds.output_dim}")
    g = ds.graph
    t0 = time.perf_counter()
    labels_np = label_propagation(g.indptr, g.indices, prefer_native=False)
    lpa_numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = label_propagation(g.indptr, g.indices)
    setup["lpa_s"] = time.perf_counter() - t0
    same = labels.dtype == labels_np.dtype and np.array_equal(labels, labels_np)
    log(f"  LPA (4 rounds, collapse guard): native {setup['lpa_s']:.2f} s, numpy "
        f"{lpa_numpy_s:.2f} s in this call ({_cores()}); {len(np.unique(labels))} labels, "
        f"equal bit for bit {'ok' if same else 'FAIL'} (host peak {_host_gb():.1f} GB)")
    if not same:
        raise AssertionError(f"native LPA labels differ from numpy's on {name}")
    del labels_np
    t0 = time.perf_counter()
    perm = cluster_order(labels)
    ds = reorder_dataset(ds, perm)
    setup["relabel_s"] = time.perf_counter() - t0
    del perm, labels, g
    log(f"  cluster order and relabelling {setup['relabel_s']:.1f} s (host peak "
        f"{_host_gb():.1f} GB)")
    torch.cuda.empty_cache()
    result_build = {}
    for way in ("numpy", "native"):  # numpy's build first, timed and dropped
        saved = graph_mod.NATIVE_BUILD_MIN_NNZ
        if way == "numpy":
            graph_mod.NATIVE_BUILD_MIN_NNZ = 1 << 62
        try:
            t0 = time.perf_counter()
            graph = graph_mod.build_graph(ds.graph, backend="bsr", device="cuda",
                                          aux_bytes=ds.num_nodes * ds.input_dim * 4)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            graph_mod.NATIVE_BUILD_MIN_NNZ = saved
        result_build[way] = dict(graph.build_s, total=seconds)
        log(f"  bsr build, {way} steps (host s): {seconds:.2f} s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in graph.build_s.items())
            + f" (K={graph.num_tiles}, host peak {_host_gb():.1f} GB)")
        if way == "numpy":
            numpy_ids = (graph.num_tiles, graph.resid_nnz)
            del graph
            torch.cuda.empty_cache()
    setup["graph_build_s"] = seconds
    _describe_graph(graph, f"  {name}", seconds)
    if (graph.num_tiles, graph.resid_nnz) != numpy_ids:
        raise AssertionError(f"native and numpy builds of {name} differ: "
                             f"{(graph.num_tiles, graph.resid_nnz)} against {numpy_ids}")
    log(f"  host peak {_host_gb():.1f} GB; the graph holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of the card")
    check_kernels_1_2(graph, errs, f" {name}")
    torch.cuda.empty_cache()
    timing = phase_timing(graph, {"bsr_tile": 0, "csr_spmm": 0}, errs, label=f"  {name}")
    torch.cuda.empty_cache()

    e = REDDIT4X_EPOCHS
    torch.cuda.reset_peak_memory_stats()
    steady = {}
    # two run_epochs calls (2 warm-up epochs and e timed), each with its trailing eval
    _counted(f"{name} dense", lambda: steady.__setitem__("dense", phase_steady(
        graph, ds, f" {name}, dense f32 features", epochs=e)),
        {"bsr_tile": 4 * (2 + e) + 4, "csr_spmm": 4 * (2 + e) + 4, "layer0_pair": 2 + e})
    peak_dense = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, xd, truths, kw = _fused_inputs(ds)
    t0 = time.perf_counter()
    _counted(f"{name} graph", lambda: train.run_epochs_chunked(
        train.create_state(cfg, "cuda"), graph, xd, *truths, epochs=e, **kw).cpu(),
        {"bsr_tile": 4 * e + 2, "csr_spmm": 4 * e + 2, "layer0_pair": e})
    graph_s = time.perf_counter() - t0
    peak_graph = torch.cuda.max_memory_allocated()
    del xd
    log(f"  run_epochs_chunked (a CUDA graph of the epoch), {e} epochs: {graph_s:.2f} s "
        f"with the capture; peak device memory {peak_graph / 1e9:.2f} GB against "
        f"{peak_dense / 1e9:.2f} GB eager")
    torch.cuda.empty_cache()
    prof = phase_profile(graph, ds, label=f"  {name}")
    torch.cuda.empty_cache()

    layer0 = phase_sparse_kernels(ds, label=f"  {name}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xs = _features(ds, sparse=True)
    setup["sparse_features_s"] = time.perf_counter() - t0
    cfg, xd, truths, kw = _fused_inputs(ds)
    zero = dict(kw, dropout_rate=0.0)
    a, b = (train.run_epochs(train.create_state(cfg, "cuda"), graph, x, *truths, epochs=3,
                             **zero).cpu().numpy() for x in (xs, xd))
    ok = np.allclose(a, b, **EPOCH_TOL)
    log(f"  sparse ({setup['sparse_features_s']:.1f} s to build on the card) vs dense "
        f"features, 3 fused epochs at dropout 0, same weights: max metric diff "
        f"{float(np.abs(a - b).max()):.3e} (rtol 1e-4, atol 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok or not np.isfinite(a).all():
        raise AssertionError(f"sparse and dense features disagree on {name}:\n{a}\n{b}")
    del xs, xd
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counted(f"{name} sparse", lambda: steady.__setitem__("sparse", phase_steady(
        graph, ds, f" {name}, sparse features", sparse=True, epochs=e)),
        {"bsr_tile": 4 * (2 + e) + 4, "csr_spmm": 6 * (2 + e) + 6, "ell_spmm": 2 + e})
    peak_sparse = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  peak device memory of the fused loop: dense features {peak_dense / 1e9:.2f} GB, "
        f"sparse {peak_sparse / 1e9:.2f} GB, of {total / 1e9:.1f} GB; host set-up "
        + ", ".join(f"{k} {v:.1f}" for k, v in setup.items()))
    result = dict(nodes=ds.num_nodes, edges=ds.graph.nnz, feature_nnz=len(ds.feature_value),
                  tiles=graph.num_tiles, residual_edges=graph.resid_nnz,
                  tile_gb=graph.tiles.numel() * graph.tiles.element_size() / 1e9,
                  epoch_ms=steady, busy_share=prof["busy_share"], busy_ms=prof["busy_ms"],
                  peak_device_gb={"dense": peak_dense / 1e9, "sparse": peak_sparse / 1e9,
                                  "graph": peak_graph / 1e9},
                  device_gb=total / 1e9, host_setup_s=setup, build_steps_s=result_build,
                  lpa_numpy_s=lpa_numpy_s,
                  kernels={line["name"]: line for line in timing}, layer0=layer0)
    del graph
    torch.cuda.empty_cache()
    # the same graph with every edge on kernel 2 (backend 'segment'): where the
    # TPU-calibrated tile break-even leaves the bsr epoch on the card
    t0 = time.perf_counter()
    graph = build_graph(ds.graph, backend="segment", device="cuda")
    torch.cuda.synchronize()
    setup["segment_build_s"] = time.perf_counter() - t0
    _counted(f"{name} segment", lambda: steady.__setitem__("segment dense", phase_steady(
        graph, ds, f" {name}, backend segment, dense f32 features", epochs=e)),
        {"csr_spmm": 4 * (2 + e) + 4, "layer0_pair": 2 + e})
    result["host_peak_gb"] = _host_gb()
    del graph, ds
    torch.cuda.empty_cache()
    return result


def _cores() -> str:
    import os

    return (f"{os.cpu_count()} cores, {len(os.sched_getaffinity(0))} in this process's "
            "affinity")


def _graph_tensors(graph) -> dict:
    """The build's output tensors: tiles, tile ids, the residual CSR(s)."""
    out = {"tiles": graph.tiles, "tile_rows": graph.tile_rows, "tile_cols": graph.tile_cols}
    for name in ("resid", "resid_t"):
        r = getattr(graph, name)
        if r is not None:
            out.update({f"{name}.row_ptr": r.row_ptr, f"{name}.cols": r.cols,
                        f"{name}.coef": r.coef})
    return {k: v for k, v in out.items() if v is not None}


def _graphsage_dumps(path: str, n: int, feats: int, classes: int, seed: int) -> None:
    """GraphSAGE reddit-format dumps (reddit-G.json, -feats.npy, -id_map.json,
    -class_map.json) of a random graph of ``n`` nodes, about 10 links each;
    every 50th node lacks its val/test annotations (the converter drops it)."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    role = rng.integers(0, 10, n)
    nodes = [{"id": f"r{i}"} if i % 50 == 49 else
             {"id": f"r{i}", "val": bool(role[i] == 8), "test": bool(role[i] == 9)}
             for i in range(n)]
    community = rng.integers(0, classes, n)
    pairs = rng.integers(0, n, (10 * n, 2))
    near = rng.random(len(pairs)) < 0.8  # most links inside a node's class
    for c in range(classes):
        members = np.flatnonzero(community == c)
        sel = near & (community[pairs[:, 0]] == c)
        pairs[sel, 1] = rng.choice(members, int(sel.sum()))
    links = [{"source": f"r{a}", "target": f"r{b}"} for a, b in pairs if a != b]
    with open(os.path.join(path, "reddit-G.json"), "w") as f:
        json.dump({"nodes": nodes, "links": links}, f)
    x = rng.normal(size=(n, feats)) + community[:, None] * 0.3
    np.save(os.path.join(path, "reddit-feats.npy"), x)
    with open(os.path.join(path, "reddit-id_map.json"), "w") as f:
        json.dump({f"r{i}": i for i in range(n)}, f)
    with open(os.path.join(path, "reddit-class_map.json"), "w") as f:
        json.dump({f"r{i}": int(community[i]) for i in range(n)}, f)


NATIVE_CLI_EPOCHS = 3


def phase_native(dataset, device: str = "cuda") -> dict:
    """(q) the native host code on the card's host: g++ builds the three
    libraries; on synth-reddit as loaded, native LPA against numpy's (labels
    bit for bit); on the main path's relabelled synth-reddit, the bsr graph
    built natively against the numpy build (tiles, tile ids, residual CSR bit
    for bit); synth-pubmed round-tripped as text through both parsers; a
    generated GraphSAGE directory converted by ``python -m
    cuda_gcn_torch.data.reddit`` and trained by ``cli.main --backend segment``
    (kernel 2) for 3 epochs. Host seconds of each, beside the host's cores."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    import numpy as np
    import torch

    from cuda_gcn_torch import cli, kernels
    from cuda_gcn_torch.data import graph as graph_mod
    from cuda_gcn_torch.data import native
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.data.parser import load_dataset
    from cuda_gcn_torch.data.reorder import label_propagation
    from cuda_gcn_torch.data.synthetic import write_dataset

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    res = {"cores": _cores(), "gxx": gxx.stdout.splitlines()[0] if gxx.stdout else "?"}
    t0 = time.perf_counter()
    built = native.build()
    res["build_s"] = time.perf_counter() - t0
    log(f"(q) native host code on the card's host ({res['cores']}): {res['gxx']} built "
        f"{sorted(built) or 'nothing (cached)'} in {res['build_s']:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in built.items()) + f") with "
        f"{' '.join(native.CXX_FLAGS)} into {native.BUILD_DIR}")

    raw = load_cached("synth-reddit")
    g = raw.graph
    t0 = time.perf_counter()
    lab_np = label_propagation(g.indptr, g.indices, prefer_native=False)
    res["lpa_numpy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lab = label_propagation(g.indptr, g.indices)
    res["lpa_native_s"] = time.perf_counter() - t0
    same = lab.dtype == lab_np.dtype and np.array_equal(lab, lab_np)
    log(f"  synth-reddit LPA (4 rounds, collapse guard): numpy {res['lpa_numpy_s']:.2f} s, "
        f"native {res['lpa_native_s']:.2f} s ({res['cores']}); {len(np.unique(lab))} "
        f"labels, equal bit for bit {'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("native LPA labels differ from numpy's on synth-reddit")
    del raw, g, lab, lab_np

    csr = dataset.graph
    torch.cuda.empty_cache()
    # warm-up: the card's context and the scatter's kernels, outside the timings
    graph_mod.build_graph(load_cached("synth-cora").graph, backend="bsr", device=device)
    builds, tensors = {}, {}
    for way in ("numpy", "native"):
        saved = graph_mod.NATIVE_BUILD_MIN_NNZ
        if way == "numpy":  # the numpy oracle: every step under the threshold
            graph_mod.NATIVE_BUILD_MIN_NNZ = 1 << 62
        try:
            t0 = time.perf_counter()
            gr = graph_mod.build_graph(csr, backend="bsr", device=device)
            torch.cuda.synchronize()
            builds[way] = dict(seconds=time.perf_counter() - t0, steps=dict(gr.build_s))
        finally:
            graph_mod.NATIVE_BUILD_MIN_NNZ = saved
        tensors[way] = _graph_tensors(gr)
        del gr
    diff = [k for k in tensors["native"] if not (
        tensors["native"][k].dtype == tensors["numpy"][k].dtype
        and torch.equal(tensors["native"][k], tensors["numpy"][k]))]
    same = tensors["native"].keys() == tensors["numpy"].keys() and not diff
    res["graph_build"] = builds
    for way, b in builds.items():
        log(f"  synth-reddit relabelled, bsr build_graph on the card, {way}: "
            f"{b['seconds']:.2f} s (" + ", ".join(f"{k} {v:.2f}" for k, v in b["steps"].items())
            + ")")
    log(f"  native against numpy build: {', '.join(tensors['native'])} equal bit for bit "
        f"{'ok' if same else 'FAIL ' + str(diff)} (K={tensors['native']['tiles'].shape[0]})")
    if not same:
        raise AssertionError(f"the native graph build differs from numpy's: {diff}")
    del tensors
    torch.cuda.empty_cache()

    pubmed = load_cached("synth-pubmed")
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(pubmed, tmp, "pubmed-text")
        parsed, secs = {}, {}
        for way, flag in (("native", True), ("numpy", False)):
            t0 = time.perf_counter()
            parsed[way] = load_dataset("pubmed-text", data_dir=tmp, use_native=flag)
            secs[way] = time.perf_counter() - t0
    a, b = parsed["native"], parsed["numpy"]
    ints = [(a.graph.indptr, b.graph.indptr), (a.graph.indices, b.graph.indices),
            (a.feature_index.indptr, b.feature_index.indptr),
            (a.feature_index.indices, b.feature_index.indices), (a.label, b.label),
            (a.split, b.split), (a.graph.indices, pubmed.graph.indices),
            (a.label, pubmed.label)]
    ok = all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in ints) and (
        (a.num_nodes, a.input_dim, a.output_dim) == (b.num_nodes, b.input_dim, b.output_dim))
    va, vb = a.feature_value, b.feature_value
    rel = float(np.max(np.abs(va - vb) / np.maximum(np.abs(vb), 1e-30))) if len(va) else 0.0
    ok = ok and va.dtype == vb.dtype and np.allclose(va, vb, rtol=1e-6, atol=0)
    res["parse_s"] = secs
    log(f"  synth-pubmed as text ({a.num_nodes} nodes, {len(va)} feature values): native parse "
        f"{secs['native']:.2f} s, numpy {secs['numpy']:.2f} s; every index array equal, "
        f"{int(np.sum(va != vb))} values differ in the last bit (strtof against float), max "
        f"rel diff {rel:.2e} (rtol 1e-6) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the native and numpy parsers disagree on synth-pubmed")

    with tempfile.TemporaryDirectory() as tmp:
        dumps, out = os.path.join(tmp, "dumps"), os.path.join(tmp, "out")
        os.makedirs(dumps)
        _graphsage_dumps(dumps, n=3000, feats=64, classes=8, seed=0)
        t0 = time.perf_counter()
        conv = subprocess.run([sys.executable, "-m", "cuda_gcn_torch.data.reddit", dumps,
                               "--out-dir", out], capture_output=True, text=True, timeout=300)
        res["convert_s"] = time.perf_counter() - t0
        if conv.returncode != 0:
            raise AssertionError(f"python -m cuda_gcn_torch.data.reddit failed:\n{conv.stderr}")
        log(f"  GraphSAGE dumps of 3,000 nodes converted in {res['convert_s']:.2f} s: "
            + " / ".join(conv.stdout.strip().splitlines()))
        kernels.reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["reddit", "--data-dir", out, "--backend", "segment",
                           "--epochs", str(NATIVE_CLI_EPOCHS)])
        launches = dict(kernels.launches)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log("  | " + line)
    num = r"-?\d+\.\d{5}"
    ok = rc == 0 and len(lines) == 4 + NATIVE_CLI_EPOCHS + 2 and all(
        re.fullmatch(rf"epoch={i} train_loss={num} train_acc={num} val_loss={num} "
                     rf"val_acc={num} time={num}", line)
        for i, line in enumerate(lines[4:4 + NATIVE_CLI_EPOCHS], start=1))
    losses = [float(line.split()[1].split("=")[1]) for line in lines[4:4 + NATIVE_CLI_EPOCHS]]
    ok = ok and all(np.isfinite(losses))
    # segment backend: kernel 2 on every adjacency pass, 4 an epoch and 2 for
    # each of the trailing and the test eval; the dense layer 0 once an epoch
    expected = {"csr_spmm": 4 * NATIVE_CLI_EPOCHS + 4, "layer0_pair": NATIVE_CLI_EPOCHS}
    log(f"  cli.main reddit --backend segment: rc {rc}, train losses {losses}; launches "
        f"{launches}; expected {expected}, 0 for the others")
    if not ok or any(v != expected.get(k, 0) for k, v in launches.items()):
        raise AssertionError("the converted reddit directory did not train as expected")
    res["cli_launches"] = launches
    return res


def phase_cli_extras():
    """(o) the CLI's extras on the card (cli.main, synth-pubmed, dropout 0.5):
    4 epochs against 2 saved and 2 resumed from the checkpoint, epochs 3-4 and
    the final checkpoints (weights, moments, step, the Philox seed and offset)
    equal bit for bit; the history files parse; --timing prints all 13 phases,
    each finite and above 0; --build-kernels exits 0."""
    import contextlib
    import csv
    import io
    import json
    import math
    import os
    import re
    import tempfile

    import numpy as np

    from cuda_gcn_torch import cli
    from cuda_gcn_torch.utils import timer as T

    def main(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["synth-pubmed", *argv])
        if rc != 0:
            raise AssertionError(f"cli.main{argv} exited {rc}:\n{buf.getvalue()}")
        return buf.getvalue()

    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    with tempfile.TemporaryDirectory() as tmp:
        path = {k: os.path.join(tmp, k) for k in ("full.npz", "half.npz", "end.npz",
                                                  "full.jsonl", "end.jsonl", "end.csv")}
        main("--epochs", "4", "--metrics-jsonl", path["full.jsonl"],
             "--save-checkpoint", path["full.npz"])
        main("--epochs", "2", "--save-checkpoint", path["half.npz"])
        T.timers.reset()
        printed_out = []
        # bsr on synth-pubmed: kernels 1 and 2 once a pass. 2 epochs (4 passes each),
        # the trailing and the test eval (2 each); then --timing: 2 forward passes,
        # and graphsum_fw and _bw each 50 times after one warm-up
        passes = 4 * 2 + 2 + 2 + 2 + 2 * 51
        _counted("(o) resumed run", lambda: printed_out.append(main(
            "--epochs", "2", "--load-checkpoint", path["half.npz"], "--save-checkpoint",
            path["end.npz"], "--metrics-jsonl", path["end.jsonl"], "--metrics-csv",
            path["end.csv"], "--timing")),
            {"bsr_tile": passes, "csr_spmm": passes, "layer0_pair": 2})
        out = printed_out[0]
        full = [json.loads(line) for line in open(path["full.jsonl"])]
        end = [json.loads(line) for line in open(path["end.jsonl"])]
        rows = list(csv.DictReader(open(path["end.csv"])))
        with np.load(path["full.npz"]) as z4, np.load(path["end.npz"]) as z22:
            same_leaves = sorted(z4.files) == sorted(z22.files) and all(
                z4[f].dtype == z22[f].dtype
                and z4[f].tobytes() == z22[f].tobytes()
                for f in z4.files)
            key = [int(v) for v in z22["leaf_7"]]
    same_rows = [[r[k] for k in keys] for r in end[1:]] == [[r[k] for k in keys]
                                                             for r in full[3:]]
    log(f"(o) cli.main synth-pubmed, dropout 0.5: 4 epochs against 2 + 2 resumed from the "
        f"checkpoint: epochs 3-4 equal bit for bit {same_rows}; final checkpoints equal bit "
        f"for bit (8 leaves, Philox seed {key[0]} offset {key[1]}) {same_leaves}")
    for line in out.strip().splitlines():
        log("  | " + line)
    if not same_rows or not same_leaves:
        raise AssertionError("a resumed run differs from the uninterrupted one")
    if end[0]["meta"]["platform"] != "CUDA" or [r["epoch"] for r in rows] != ["1", "2"] \
            or [float(r["val_loss"]) for r in rows] != [r["val_loss"] for r in end[1:]]:
        raise AssertionError("the history files do not hold the run")
    printed = dict(re.findall(r"^(\w+) average time: (\d+\.\d{3})ms$", out, re.M))
    phases = [getattr(T, n) for n in dir(T) if n.startswith("TMR_")]
    avg = {name: T.timers.average_ms(name) for name in phases}
    if sorted(printed) != sorted(phases) or not all(
            math.isfinite(v) and v > 0 for v in avg.values()):
        raise AssertionError(f"--timing did not time every phase: {printed} {avg}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["synth-pubmed", "--build-kernels"])
    log(f"  --build-kernels: rc {rc}, {buf.getvalue().strip()}")
    if rc != 0:
        raise AssertionError("--build-kernels failed")
    return avg


SHARDED_EPOCHS = 10       # world size 1 over NCCL
SHARED_EPOCHS = 5         # 2 and 4 ranks sharing the card over gloo
SHARDED_WARM = 2          # warm-up epochs before a timed fused loop
PROFILED_EPOCHS = 3
BF16_HALO_TOL = dict(loss_rtol=5e-3, acc_atol=5e-3)  # the JAX package's bf16 loss
# tolerance (tests/test_parallel.py:582-586); accuracy within half a percent
# float32 halo, P > 1 (_compare_runs): the losses' relative limit and the
# accuracy flips allowed per split, between the sound readings (losses up to
# 6.2e-7, up to 2 nodes) and the bf16-halo control's (losses from 1.3e-6,
# from 3 nodes; PERF.md §6)
F32_PARTS_LOSS_RTOL = 1e-6
F32_PARTS_ACC_NODES = 2


def _busy(fn) -> tuple[float, float]:
    """(device busy ms, wall ms) of ``fn()`` under torch.profiler: the self
    device time of every kernel this process launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if (dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", ""))
                and not getattr(evt, "is_user_annotation", False)):
            busy += dev_us / 1e3
    return busy, wall


def _sharded_rank(rank, world, init_method, cfg, backend, epochs, halos, resume, shard):
    """(p), one rank: NCCL on cuda:<rank> or gloo on cuda:0. Per halo type:
    ``sharded.run_epochs`` of ``epochs`` with every launch count set to 0
    just before and read just after, the test eval; then a timed fused loop
    after a warm-up (ms per epoch, halo rows and bytes this rank shipped),
    and rank 0's busy share under the profiler. With ``resume`` (dropout
    0.5): 4 epochs against 2, a checkpoint, and 2 more, bit for bit."""
    import dataclasses
    import os
    import tempfile

    import torch

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.parallel import multihost, sharded
    from cuda_gcn_torch.utils.checkpoint import restore_state, save_state

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    t0 = time.perf_counter()
    multihost.initialize(init_method, world, rank, backend=backend, device=device)
    torch.cuda.set_device(device)
    kernels.build()
    inputs, truths = sharded.shard_inputs(cfg, shard, device)
    torch.cuda.synchronize()
    out = dict(setup_s=time.perf_counter() - t0, stage_host=inputs.exchange.stage_host,
               block=inputs.block, halo_space=inputs.boundary.n_in,
               tiles=inputs.interior.square.num_tiles,
               interior_edges=inputs.interior.square.resid_nnz,
               boundary_edges=inputs.boundary.resid.nnz, runs={})
    ex = inputs.exchange
    for halo in halos:
        c = dataclasses.replace(cfg, halo_dtype=halo)
        state = sharded.create_state(c, device, rank)
        kernels.reset_launches()
        m = sharded.run_epochs(state, inputs, truths[1], truths[2], c, epochs)
        test = torch.stack(sharded.eval_step(state.model, inputs, truths[3], c))
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        run = dict(metrics=m.cpu().numpy(), test=test.cpu().numpy(), launches=launches)
        st = sharded.create_state(c, device, rank)
        sharded.run_epochs(st, inputs, truths[1], truths[2], c, SHARDED_WARM)
        rows0, bytes0 = ex.sent_rows, ex.sent_bytes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded.run_epochs(st, inputs, truths[1], truths[2], c, epochs).cpu()
        run["epoch_ms"] = (time.perf_counter() - t0) * 1e3 / epochs
        run["halo_rows"] = (ex.sent_rows - rows0) / epochs
        run["halo_bytes"] = (ex.sent_bytes - bytes0) / epochs

        def profiled():
            sharded.run_epochs(st, inputs, truths[1], truths[2], c, PROFILED_EPOCHS).cpu()

        if rank == 0:
            busy, wall = _busy(profiled)
            run.update(busy_ms=busy / PROFILED_EPOCHS, wall_ms=wall / PROFILED_EPOCHS,
                       busy_share=busy / wall)
        else:
            profiled()
        out["runs"][halo] = run
    if resume:
        c = dataclasses.replace(cfg, dropout=0.5)
        full = sharded.create_state(c, device, rank)
        m4 = sharded.run_epochs(full, inputs, truths[1], truths[2], c, 4).cpu()
        half = sharded.create_state(c, device, rank)
        sharded.run_epochs(half, inputs, truths[1], truths[2], c, 2)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "half.npz")
            save_state(path, half)
            back = sharded.create_state(c, device, rank, restore_state(
                path, like=train.create_state(c, device)))
        m2 = sharded.run_epochs(back, inputs, truths[1], truths[2], c, 2).cpu()
        same_params = all(torch.equal(a, b) for a, b in zip(full.model.parameters(),
                                                              back.model.parameters()))
        out["resume"] = dict(rows_equal=bool(torch.equal(m4[2:], m2)),
                             params_equal=same_params,
                             generator=[back.generator.initial_seed(),
                                        back.generator.get_offset()])
    return out


def _compare_runs(label, got, want, counts, halo: str, world: int):
    """Metric rows (and the test row) of a sharded run against the
    single-device run, read as the largest loss difference relative to the
    loss and the largest accuracy difference in nodes of its split
    (``counts``: train and val for an epoch row, test for the test row).
    A float32 halo is held to EPOCH_TOL at world size 1, and at P > 1 to
    ``F32_PARTS_LOSS_RTOL`` on the losses and ``F32_PARTS_ACC_NODES`` nodes on
    the accuracies: the parts' interiors hold other tiles than the whole
    graph (a boundary edge is in no tile and keeps its f32 coefficient where
    a tile rounds it to bf16), so that a prediction at a near tie may flip. A bfloat16 halo is held to
    BF16_HALO_TOL. Returns (max |diff|, loss reading, accuracy reading,
    whether the float32 limits hold)."""
    import numpy as np

    diff = np.abs(got - want)
    loss_rel = float((diff[:, 0::2] / np.maximum(np.abs(want[:, 0::2]), 1e-30)).max())
    n = np.zeros_like(got)
    n[:-1, 1], n[:-1, 3], n[-1, 1] = counts[1], counts[2], counts[3]
    acc_nodes = int(np.rint(diff[:, 1::2] * n[:, 1::2]).max())
    if world == 1:
        f32_ok = np.allclose(got, want, **EPOCH_TOL)
    else:
        f32_ok = loss_rel <= F32_PARTS_LOSS_RTOL and acc_nodes <= F32_PARTS_ACC_NODES
    if halo == "float32":
        ok = f32_ok
        tol = ("rtol 1e-4, atol 1e-5" if world == 1 else
               f"losses rtol {F32_PARTS_LOSS_RTOL:g}, accuracies {F32_PARTS_ACC_NODES} nodes")
    else:
        ok = (np.allclose(got[:, 0::2], want[:, 0::2], rtol=BF16_HALO_TOL["loss_rtol"])
              and np.allclose(got[:, 1::2], want[:, 1::2], rtol=0,
                              atol=BF16_HALO_TOL["acc_atol"]))
        tol = ("loss rtol 5e-3, accuracy atol 5e-3; the float32 limits "
               + ("hold" if f32_ok else "do not hold"))
    log(f"  {label}: against the single-device run, max |diff| {float(diff.max()):.3e}, "
        f"loss {loss_rel:.3e} relative, accuracy {acc_nodes} node(s) ({tol}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok or not np.isfinite(got).all():
        raise AssertionError(f"{label} disagrees with the single-device run:\n{got}\n{want}")
    return float(diff.max()), loss_rel, acc_nodes, bool(f32_ok)


def _rank_kernels(part, x, errs):
    """Kernels 1 and 2 on one rank's operators at the main path's widths:
    the square interior (tiles and residual) in both orientations and the
    rectangular boundary (n_in = halo_space) in both, against their plain
    versions; then timed beside the bound (bytes) and the library's call."""
    import torch

    from cuda_gcn_torch.ops.bsr import bsr_tile_contract, bsr_tile_contract_plain
    from cuda_gcn_torch.ops.residual import residual_spmm, residual_spmm_plain
    from cuda_gcn_torch.parallel import sharded

    inputs = sharded.make_sharded_inputs(part, x, "cuda", sharded.HaloExchange(
        part.rank, part.n_parts, part.hmax_k))
    g = inputs.interior.square
    b = inputs.boundary
    n, hs, k, tb, tbl = g.n_nodes, b.n_in, g.num_tiles, g.tb, g.t_blocks
    gen = torch.Generator(device="cuda").manual_seed(2)
    log(f"  kernels 1 and 2 on rank 0's operators: block {n}, halo_space {hs}, K={k} tiles, "
        f"interior residual {g.resid_nnz} edges, boundary {b.resid.nnz} edges")

    def resid(csr, h, out=None):
        return residual_spmm(csr.row_ptr, csr.cols, csr.coef, h, out, work=csr.work)

    def resid_plain(csr, h, out=None):
        return residual_spmm_plain(csr.row_ptr, csr.cols, csr.coef, h, out)

    cases = {  # name: (kernel, its plain version, rows of h)
        "interior bsr_tile": (
            lambda h: bsr_tile_contract(g.tiles, g.tile_rows, g.tile_cols, h, n, tbl,
                                        plan=g.plan),
            lambda h: bsr_tile_contract_plain(g.tiles, g.tile_rows, g.tile_cols, h, n, tbl), n),
        "interior bsr_tile transposed": (
            lambda h: bsr_tile_contract(g.tiles, g.tile_cols, g.tile_rows, h, n, tbl,
                                        transpose=True, plan=g.plan_t),
            lambda h: bsr_tile_contract_plain(g.tiles, g.tile_cols, g.tile_rows, h, n, tbl,
                                              transpose=True), n),
        "interior csr_spmm": (lambda h: resid(g.resid, h), lambda h: resid_plain(g.resid, h), n),
        "interior csr_spmm transposed": (lambda h: resid(g.resid_t, h),
                                         lambda h: resid_plain(g.resid_t, h), n),
        "boundary csr_spmm": (lambda h: resid(b.resid, h), lambda h: resid_plain(b.resid, h),
                              hs),
        "boundary csr_spmm transposed": (lambda h: resid(b.resid_t, h),
                                         lambda h: resid_plain(b.resid_t, h), n),
    }
    timing = {"bsr_tile": {}, "csr_spmm interior": {}, "csr_spmm boundary": {}}
    tile_bytes = g.tiles.numel() * g.tiles.element_size()
    for d in WIDTHS:
        for name, (fn, plain, rows) in cases.items():
            h = torch.randn(rows, d, generator=gen, device="cuda")
            got = fn(h)
            errs[name.split()[1]] = max(errs[name.split()[1]],
                                        check(f"{name} d={d}", got, plain(h)))
            if not torch.equal(got, fn(h)):
                raise AssertionError(f"{name} d={d} is not bitwise repeatable")
        h = torch.randn(n, d, generator=gen, device="cuda")
        hh = torch.randn(hs, d, generator=gen, device="cuda")
        out = torch.zeros(n, d, device="cuda")
        for key, fn, plain, nbytes, lib in (
                ("bsr_tile", cases["interior bsr_tile"][0], cases["interior bsr_tile"][1],
                 tile_bytes + 4 * (2 * k + 2 * tbl + 1) + 8 * n * d, None),
                ("csr_spmm interior", lambda hv: resid(g.resid, hv, out),
                 lambda hv: resid_plain(g.resid, hv, out),
                 12 * g.resid.work.beg.numel() + 8 * g.resid_nnz + 12 * n * d, g.resid),
                ("csr_spmm boundary", lambda hv: resid(b.resid, hv, out),
                 lambda hv: resid_plain(b.resid, hv, out),
                 12 * b.resid.work.beg.numel() + 8 * b.resid.nnz + 4 * hs * d + 8 * n * d,
                 b.resid)):
            hv = hh if key == "csr_spmm boundary" else h
            lib_ms = None
            if lib is not None:
                a = torch.sparse_csr_tensor(lib.row_ptr.long(), lib.cols.long(), lib.coef,
                                            size=(n, hv.shape[0]))
                lib_ms, _ = _library_ms(lambda: (lambda: out.addmm_(a, hv)), 20)
            bound, by, _, _ = _bound_at(nbytes, 0.0)
            timing[key][str(d)] = dict(ms=cuda_ms(lambda: fn(hv), 20),
                                       plain_ms=cuda_ms(lambda: plain(hv), 3),
                                       bound_ms=bound, bound_by=by, library_ms=lib_ms)
    d = WIDTHS[-1]
    h = torch.randn(n, d, generator=gen, device="cuda")

    def bsr_lib():
        a = torch.sparse_bsr_tensor(g.plan.ptr.long(), g.tile_cols.long(), g.tiles.float(),
                                    size=(tbl * tb, tbl * tb))
        hp = torch.zeros(tbl * tb, d, device="cuda")
        hp[:n] = h
        return lambda: a @ hp

    timing["bsr_tile"][str(d)]["library_ms"], _ = _library_ms(bsr_lib, 3)
    for key, by_d in timing.items():
        log(f"  {key} on rank 0 by width: " + "; ".join(
            f"d={w} {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} "
            f"by {r['bound_by']}, library {_fmt_ms(r['library_ms'])})" for w, r in by_d.items()))
    return dict(block=n, halo_space=hs, tiles=k, interior_residual_edges=g.resid_nnz,
                boundary_edges=b.resid.nnz, timing=timing)


def _single_device(cfg, dataset):
    """The single-device bsr run on ``dataset`` at ``cfg``'s dropout, one
    graph for all: the metric rows and test row of ``train.run_epochs`` over
    ``SHARDED_EPOCHS`` and ``SHARED_EPOCHS`` epochs, and its ms per fused
    epoch over ``SHARDED_EPOCHS`` after ``SHARDED_WARM``, timed as a rank of
    (p) times its loop."""
    import numpy as np
    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.data.graph import build_graph

    graph = build_graph(dataset.graph, backend="bsr", device="cuda")
    x = torch.from_numpy(dataset.dense_features(np.float32)).cuda()
    truths = [train.make_truth(dataset.split, dataset.label, s, "cuda") for s in (1, 2, 3)]
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    ref = {}
    for e in (SHARDED_EPOCHS, SHARED_EPOCHS):
        state = train.create_state(cfg, "cuda")
        m = train.run_epochs(state, graph, x, *truths[:2], epochs=e, **kw).cpu().numpy()
        test = torch.stack(train.eval_step(state.model, graph, x, truths[2],
                                           weight_decay=cfg.weight_decay)).cpu().numpy()
        ref[e] = np.concatenate([m, [[*test, 0, 0]]])
    state = train.create_state(cfg, "cuda")
    train.run_epochs(state, graph, x, *truths[:2], epochs=SHARDED_WARM, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.run_epochs(state, graph, x, *truths[:2], epochs=SHARDED_EPOCHS, **kw).cpu()
    return ref, (time.perf_counter() - t0) * 1e3 / SHARDED_EPOCHS


def _expected_launches(epochs: int, world: int) -> dict:
    """One rank's launches in run_epochs(epochs) and a test eval: 4
    aggregations an epoch, 2 for the trailing eval and 2 for the test eval,
    each one interior tile pass (kernel 1) and one interior residual pass
    (kernel 2), plus a boundary pass (kernel 2) where there is a halo."""
    passes = 4 * epochs + 2 + 2
    return {"bsr_tile": passes, "csr_spmm": passes * (2 if world > 1 else 1)}


def phase_sharded():
    """(p) the sharded trainer on synth-reddit at full width (602-16-41, bsr
    interiors), relabelled and cut by ``partition_layout``: world size 1 over
    NCCL (10 epochs against the single-device run on the same relabelled
    dataset; resumption at dropout 0.5), 2 and 4 ranks sharing the card over
    gloo (5 epochs at dropout 0 at both halo types against the single-device
    run, ``_compare_runs``), kernels 1 and 2 on one rank's operators, and
    synth-pubmed through ``cli.main --mesh 1``."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    from cuda_gcn_torch import cli
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached, reorder_dataset
    from cuda_gcn_torch.data.reorder import label_propagation, partition_layout
    from cuda_gcn_torch.parallel import multihost, sharded

    t_phase = time.perf_counter()
    ds = load_cached("synth-reddit")
    t0 = time.perf_counter()
    labels = label_propagation(ds.graph.indptr, ds.graph.indices)
    deg = np.diff(ds.graph.indptr.astype(np.int64))
    log(f"(p) sharded trainer on synth-reddit ({ds.num_nodes} nodes, {ds.graph.nnz} edges, "
        f"{ds.input_dim}-16-{ds.output_dim}, bsr interiors); LPA {time.perf_counter() - t0:.1f} s")
    cfg = ds.apply_config(GCNConfig(graphsum_backend="bsr", dropout=0.0, seed=0,
                                    reorder="none"))
    errs = {"bsr_tile": 0.0, "csr_spmm": 0.0}
    result = {"errs": errs, "worlds": {}}
    for world in (1, 2, 4):
        t0 = time.perf_counter()
        perm, cuts = partition_layout(ds.graph.indptr, ds.graph.indices, labels, world,
                                      weights=deg)
        dsw = reorder_dataset(ds, perm)
        # the ranks share the one card and its tile budget
        _, shards, pg = sharded.prepare_sharded(cfg, dsw, world, cuts=cuts, device="cuda")
        boundary = sum(s.boundary_edges for s in shards) / ds.graph.nnz
        log(f"  P={world}: relabelled and partitioned in {time.perf_counter() - t0:.1f} s: "
            f"block {pg.block}, halo_space {pg.halo_space} (hmax_k {pg.hmax_k}), tiles per "
            f"part {pg.i_tile_counts.tolist()}, boundary edge fraction {boundary:.4f}")
        if world == 1:
            t0 = time.perf_counter()
            ref, result["single_epoch_ms"] = _single_device(cfg, dsw)
            log(f"  single-device references on the P=1 layout (bsr graph, run_epochs, dropout "
                f"0, 10 and 5 epochs) in {time.perf_counter() - t0:.1f} s; its fused loop "
                f"{result['single_epoch_ms']:.2f} ms/epoch over {SHARDED_EPOCHS} epochs after "
                f"{SHARDED_WARM} (the yardstick of P=1 below, same call)")
        if world == 2:
            result["rank_kernels"] = _rank_kernels(shards[0].part, shards[0].x, errs)
        backend = "nccl" if world == 1 else "gloo"
        epochs = SHARDED_EPOCHS if world == 1 else SHARED_EPOCHS
        halos = ("float32",) if world == 1 else ("float32", "bfloat16")
        t0 = time.perf_counter()
        ranks = multihost.run_ranks(_sharded_rank, world,
                                    (cfg, backend, epochs, halos, world == 1),
                                    rank_args=[(s,) for s in shards], timeout=600)
        r0 = ranks[0]
        log(f"  P={world} over {backend}{' (ranks sharing one card)' if world > 1 else ''}: "
            f"{world} ranks ran in {time.perf_counter() - t0:.1f} s (rank 0 set-up "
            f"{r0['setup_s']:.1f} s); transport: " + (
                "CUDA payloads staged through pinned host buffers (gloo sends and receives "
                "host memory)" if r0["stage_host"] else
                (f"{backend} on the payloads as they are" if world > 1
                 else "no exchange (one part)")))
        want = _expected_launches(epochs, world)
        info = dict(backend=backend, block=pg.block, halo_space=pg.halo_space,
                    boundary_fraction=boundary, stage_host=r0["stage_host"], runs={})
        for halo in halos:
            rows = [r["runs"][halo] for r in ranks]
            got = np.concatenate([rows[0]["metrics"], [[*rows[0]["test"], 0, 0]]])
            diff, loss_rel, acc_nodes, f32_ok = _compare_runs(
                f"P={world} {halo} halo, {epochs} epochs", got, ref[epochs],
                shards[0].counts, halo, world)
            for r, row in enumerate(rows):
                if row["launches"] != {**{k: 0 for k in row["launches"]}, **want}:
                    raise AssertionError(f"P={world} rank {r}: launches {row['launches']}, "
                                         f"expected {want}")
            log(f"  P={world} {halo} halo: " + "; ".join(
                f"rank {r}: {row['epoch_ms']:.2f} ms/fused epoch"
                f"{' (ranks sharing one card)' if world > 1 else ''}, halo {row['halo_rows']:.0f} "
                f"rows / {row['halo_bytes'] / 1e6:.3f} MB shipped an epoch"
                for r, row in enumerate(rows))
                + f"; launches per rank {rows[0]['launches']['bsr_tile']} bsr_tile, "
                f"{rows[0]['launches']['csr_spmm']} csr_spmm (expected {want}); rank 0 busy "
                f"{rows[0]['busy_ms']:.2f} of {rows[0]['wall_ms']:.2f} ms an epoch "
                f"(busy share {rows[0]['busy_share']:.3f})")
            info["runs"][halo] = dict(
                max_metric_diff=diff, loss_rel_diff=loss_rel, acc_diff_nodes=acc_nodes,
                f32_limits_hold=f32_ok, epoch_ms=[row["epoch_ms"] for row in rows],
                halo_rows=[row["halo_rows"] for row in rows],
                halo_bytes=[row["halo_bytes"] for row in rows],
                busy_share=rows[0]["busy_share"], launches=rows[0]["launches"])
        if world > 1:  # the wire type: a bf16 halo ships half the bytes of the f32 one
            f32, bf16 = ([(row["halo_rows"], row["halo_bytes"]) for row in
                          (r["runs"][h] for r in ranks)] for h in halos)
            wire_ok = all(a[0] == b[0] > 0 and a[1] == 2 * b[1] for a, b in zip(f32, bf16))
            log(f"  P={world} wire: float32 halo {f32[0][1] / f32[0][0]:.1f} bytes a row, "
                f"bfloat16 {bf16[0][1] / bf16[0][0]:.1f}, same rows on every rank "
                f"{'ok' if wire_ok else 'FAIL'}")
            if not wire_ok:
                raise AssertionError(f"P={world}: halo rows/bytes {f32} (f32) {bf16} (bf16)")
        if world == 1:
            res = r0["resume"]
            log(f"  P=1 dropout 0.5: 4 epochs against 2 + a checkpoint + 2: rows 3-4 equal bit "
                f"for bit {res['rows_equal']}, final weights {res['params_equal']} (Philox "
                f"seed {res['generator'][0]}, offset {res['generator'][1]})")
            if not (res["rows_equal"] and res["params_equal"]):
                raise AssertionError("a resumed sharded run differs from the uninterrupted one")
        result["worlds"][world] = info
        del shards, pg, dsw
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.jsonl") for k in ("mesh", "single")}
        flags = ["--epochs", "3", "--dropout", "0", "--halo-dtype", "float32"]
        sys.stdout.flush()
        t0 = time.perf_counter()
        rc = cli.main(["synth-pubmed", "--mesh", "1", *flags, "--metrics-jsonl", paths["mesh"]])
        mesh_s = time.perf_counter() - t0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_single = cli.main(["synth-pubmed", *flags, "--metrics-jsonl", paths["single"]])
        rows = {k: [json.loads(line) for line in open(p)][1:] for k, p in paths.items()}
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    a, b = (np.array([[r[k] for k in keys] for r in rows[k]]) for k in ("mesh", "single"))
    ok = rc == rc_single == 0 and a.shape == b.shape == (3, 4) and np.allclose(a, b, **EPOCH_TOL)
    log(f"  cli.main synth-pubmed --mesh 1 (NCCL, {mesh_s:.1f} s): rc {rc}, 3 epochs against "
        f"the single-device CLI run, max metric diff {float(np.abs(a - b).max()):.3e} "
        f"(rtol 1e-4, atol 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"cli --mesh 1 disagrees with the single-device CLI:\n{a}\n{b}")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"  phase (p) took {result['seconds']:.1f} s")
    return result


# (r) the epoch as a replayed CUDA graph (train.run_epochs_chunked and its kin)

GRAPH_EPOCHS = 100        # as bench.py runs the main path
GRAPH_REPLAYS = 20        # profiled steady epochs of each loop
GRAPH_ES = dict(epochs=200, early_stopping=3)
GRAPH_SHARDED_EPOCHS = 20
GRAPH_RTOL = 1e-6         # where graph and eager are not bit for bit


def _state_leaves(state) -> dict:
    """A train state's weights, Adam moments and step and its generator's
    state, on the host, by name."""
    leaves = {f"w.{k}": p.detach() for k, p in state.model.named_parameters()}
    leaves.update({f"m.{k}": t for k, t in state.opt.m.items()})
    leaves.update({f"v.{k}": t for k, t in state.opt.v.items()})
    leaves["step"] = state.opt.step
    leaves["generator"] = state.generator.get_state()
    return {k: v.cpu() for k, v in leaves.items()}


def _compare(label: str, got: dict, want: dict) -> str:
    """'bit for bit' when every tensor of ``got`` equals ``want``'s; else the
    leaves that differ, each within rtol ``GRAPH_RTOL`` or the check fails."""
    import torch

    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if not differ:
        return "bit for bit"
    worst = {}
    for k in differ:
        a, b = got[k].double(), want[k].double()
        if a.shape != b.shape or k in ("step", "generator"):
            raise AssertionError(f"{label}: {k} differs between the graph and the eager loop")
        worst[k] = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
    note = ", ".join(f"{k} rel {v:.2e}" for k, v in worst.items())
    if max(worst.values()) > GRAPH_RTOL:
        raise AssertionError(f"{label}: graph and eager differ beyond rtol {GRAPH_RTOL}: {note}")
    return f"within rtol {GRAPH_RTOL}, not bit for bit: {note}"


def _port_kernel_ms(prof) -> dict:
    """Device ms of every kernel of the port seen by the profiler, by name."""
    out = {}
    own = PORT_KERNELS
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if (dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", ""))
                and not getattr(evt, "is_user_annotation", False)):
            key = next((o for o in own if o in evt.key), "other")
            out[key] = out.get(key, 0.0) + dev_us / 1e3
    return out


GRAPH_TURNS = 3           # timed turns of each steady loop, taken in alternation


def _steady(fns: dict, n: int) -> dict:
    """``n`` calls (one epoch each) of every function of ``fns`` on a warm
    device, ``GRAPH_TURNS`` times in alternation (a, b, b, a, a, b): host µs
    per call before any wait and wall ms per epoch to the end of the work,
    each turn's and their median; then, once each under torch.profiler, the
    device's busy ms per epoch, its busy share and the port's kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = list(fns)
    turns = {k: [] for k in names}
    for t in range(GRAPH_TURNS):
        for k in (names if t % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fns[k]()
            host_us = (time.perf_counter() - t0) * 1e6 / n
            torch.cuda.synchronize()
            turns[k].append(((time.perf_counter() - t0) * 1e3 / n, host_us))
    out = {}
    for k in names:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(n):
                fns[k]()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t1) * 1e3
        by_kernel = _port_kernel_ms(prof)
        busy = sum(by_kernel.values())
        ms = sorted(m for m, _ in turns[k])
        out[k] = dict(ms=ms[len(ms) // 2], ms_turns=[m for m, _ in turns[k]],
                      host_us=sorted(h for _, h in turns[k])[len(ms) // 2],
                      busy_ms=busy / n, busy_share=busy / prof_wall,
                      kernels=sorted(x for x in by_kernel if x != "other"))
    return out


class _GraphSpy:
    """Keeps the ``EpochGraph`` of a run and times its capture and the host's
    share of each replay (the call alone), for the length of a ``with``."""

    def __enter__(self):
        from cuda_gcn_torch import graphs

        self.cls, self.graphs, self.capture_s, self.replay_us = graphs.EpochGraph, [], [], []
        self.real = (self.cls.capture, self.cls.replay)
        spy = self

        def capture(eg):
            t0 = time.perf_counter()
            spy.real[0](eg)
            spy.capture_s.append(time.perf_counter() - t0)
            spy.graphs.append(eg)

        def replay(eg):
            t0 = time.perf_counter()
            spy.real[1](eg)
            spy.replay_us.append((time.perf_counter() - t0) * 1e6)

        self.cls.capture, self.cls.replay = capture, replay
        return self

    def __exit__(self, *exc):
        self.cls.capture, self.cls.replay = self.real


def _graph_against_eager(label: str, graph, x, truths, cfg, epochs: int, expected: dict):
    """``run_epochs_chunked`` (a CUDA graph) against ``run_epochs`` (eager),
    each from a fresh ``create_state``: metrics, weights, moments, step and
    generator equal; launches as the eager loop's, counted from 0; the run's
    ms per epoch; then each loop's steady epoch (``_steady``)."""
    import torch

    from cuda_gcn_torch import graphs, kernels, train

    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    runs = {}
    for way in ("eager", "graph"):
        state = train.create_state(cfg, "cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        times = []
        with _GraphSpy() as spy:
            t0 = time.perf_counter()
            if way == "eager":
                m = train.run_epochs(state, graph, x, *truths, epochs=epochs, **kw)
            else:
                m = train.run_epochs_chunked(state, graph, x, *truths, epochs=epochs,
                                             times_out=times, **kw)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        runs[way] = dict(state=state, metrics=m.cpu(), launches=dict(kernels.launches),
                         run_ms=run_s * 1e3 / epochs, spy=spy, times=times)
    e, g = runs["eager"], runs["graph"]
    spy = g["spy"]
    agree = _compare(label, dict(metrics=g["metrics"], **_state_leaves(g["state"])),
                     dict(metrics=e["metrics"], **_state_leaves(e["state"])))
    log(f"  {label}, {epochs} epochs: graph against eager {agree}; launches graph "
        f"{ {k: v for k, v in g['launches'].items() if v} } eager "
        f"{ {k: v for k, v in e['launches'].items() if v} }, expected {expected}")
    if g["launches"] != e["launches"] or any(g["launches"][k] != expected.get(k, 0)
                                             for k in g["launches"]):
        raise AssertionError(f"{label}: the graph's launch counts are not the eager loop's")
    if len(spy.graphs) != 1 or len(spy.replay_us) != epochs - 1:
        raise AssertionError(f"{label}: expected one capture and {epochs - 1} replays, "
                             f"got {len(spy.graphs)} and {len(spy.replay_us)}")
    replay_us = sorted(spy.replay_us)
    out = dict(agree=agree, epochs=epochs, launches=g["launches"],
               run_ms={"eager": e["run_ms"], "graph": g["run_ms"]},
               capture_s=spy.capture_s[0],
               replay_host_us_median=replay_us[len(replay_us) // 2])
    chunks = [t * 1e3 for i, t in enumerate(g["times"]) if i == 0 or t != g["times"][i - 1]]
    out["chunk_ms_per_epoch"] = chunks
    log(f"  whole call: eager {e['run_ms']:.3f} ms/epoch, graph {g['run_ms']:.3f} ms/epoch "
        f"(capture {spy.capture_s[0] * 1e3:.1f} ms, host {out['replay_host_us_median']:.1f} "
        f"us per replay, median of {len(replay_us)}); the graph's chunks, ms per epoch: "
        + ", ".join(f"{t:.3f}" for t in chunks))
    # steady epochs: the eager state goes on eagerly, the graph's state by the
    # replays of a graph of the same epoch without the metric row, which has
    # no room past the run's epochs
    state = g["state"]
    eg = graphs.EpochGraph(lambda: train._fused_epoch(state, graph, x, *truths, **kw),
                           (state.generator,))
    eg.run()
    eg.run()
    steady = _steady({"eager": lambda: train._fused_epoch(e["state"], graph, x, *truths, **kw),
                      "graph": eg.replay}, GRAPH_REPLAYS)
    out["steady"] = steady
    if steady["graph"]["kernels"] != steady["eager"]["kernels"] or not steady["graph"]["kernels"]:
        raise AssertionError(f"{label}: the port's kernels in the replays "
                             f"{steady['graph']['kernels']} are not the eager epoch's "
                             f"{steady['eager']['kernels']}")
    for way, r in steady.items():
        log(f"  steady {way}, {GRAPH_REPLAYS} epochs: {r['ms']:.3f} ms/epoch (median of "
            f"turns {', '.join(f'{m:.3f}' for m in r['ms_turns'])}), host {r['host_us']:.1f} "
            f"us per epoch, device busy {r['busy_ms']:.3f} ms/epoch (share "
            f"{r['busy_share']:.3f}); port kernels {r['kernels']}")
    return out


def _es_against_eager(graph, x, truths, cfg):
    """The early-stopping graph against ``run_epochs_es``: the same stop epoch,
    metrics and state; ms per epoch of each; the host's cost of one read of the
    4-byte stop flag on an idle card."""
    import torch

    from cuda_gcn_torch import kernels, train

    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    es = dict(epochs=cfg.epochs, es_window=cfg.early_stopping)
    runs = {}
    for way in ("eager", "graph"):
        state = train.create_state(cfg, "cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        fn = train.run_epochs_es if way == "eager" else train.run_epochs_es_chunked
        m, stopped = fn(state, graph, x, *truths, **es, **kw)
        torch.cuda.synchronize()
        runs[way] = dict(m=m.cpu(), stopped=stopped, state=state,
                         ms=(time.perf_counter() - t0) * 1e3 / len(m),
                         launches=dict(kernels.launches))
    e, g = runs["eager"], runs["graph"]
    agree = _compare("(r) early stopping", dict(metrics=g["m"], **_state_leaves(g["state"])),
                     dict(metrics=e["m"], **_state_leaves(e["state"])))
    flag = torch.zeros((), dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    reads = []
    for _ in range(100):
        t0 = time.perf_counter()
        bool(flag)
        reads.append((time.perf_counter() - t0) * 1e6)
    read_us = sorted(reads)[len(reads) // 2]
    log(f"  early stopping (window {cfg.early_stopping}, dropout {cfg.dropout}): eager "
        f"stopped after {len(e['m'])} epochs ({e['stopped']}), graph after {len(g['m'])} "
        f"({g['stopped']}); {agree}; eager {e['ms']:.3f} ms/epoch, graph {g['ms']:.3f} "
        f"ms/epoch; one read of the stop flag on an idle card {read_us:.1f} us (median of "
        f"100); launches {g['launches']['ell_spmm']} (eager {e['launches']['ell_spmm']})")
    if len(g["m"]) != len(e["m"]) or g["stopped"] != e["stopped"] or not e["stopped"] \
            or g["launches"] != e["launches"]:
        raise AssertionError("the early-stopping graph does not stop where the eager loop does")
    return dict(epochs=len(e["m"]), agree=agree, ms={"eager": e["ms"], "graph": g["ms"]},
                flag_read_us=read_us)


def _resume_through_run(ds):
    """``train.run`` 4 epochs against 2 + a checkpoint + 2 at dropout 0.5."""
    import dataclasses
    import os
    import tempfile

    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.utils.checkpoint import restore_state, save_state

    cfg = GCNConfig(graphsum_backend="pallas", seed=0)
    full = train.run(dataclasses.replace(cfg, epochs=4), ds, device="cuda", verbose=False)
    half = train.run(dataclasses.replace(cfg, epochs=2), ds, device="cuda", verbose=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "half.npz")
        save_state(path, half.state)
        like = train.create_state(ds.apply_config(cfg), "cuda")
        resumed = train.run(dataclasses.replace(cfg, epochs=2), ds, device="cuda",
                            verbose=False, initial_state=restore_state(path, like))
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    rows = ([[h[k] for k in keys] for h in resumed.history]
            == [[h[k] for k in keys] for h in full.history[2:]])
    agree = _compare("(r) resumption", _state_leaves(resumed.state), _state_leaves(full.state))
    log(f"  train.run synth-pubmed pallas, dropout {cfg.dropout}: 4 epochs against 2 + "
        f"checkpoint + 2: epochs 3-4 equal bit for bit {rows}; final state {agree}")
    if not rows or agree != "bit for bit":
        raise AssertionError("a resumed graph run differs from the uninterrupted one")
    torch.cuda.synchronize()


_NO_COMPILER = """
import sys
from cuda_gcn_torch import cli, kernels
from cuda_gcn_torch.data import native

def refuse():
    raise RuntimeError("a compiler was called")

kernels._nvcc = native._gxx = refuse
sys.exit(cli.main(sys.argv[1:]))
"""


def _prime_cli():
    """``cli.main synth-pubmed --prime-cache --compilation-cache D`` in a
    process of its own, D fresh; then ``--compilation-cache D --epochs 3`` in
    another, where calling nvcc or g++ raises, and D gains no file."""
    import os
    import shutil

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.data import native

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "prime_check")
    shutil.rmtree(cache, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    prime = subprocess.run([sys.executable, "-m", "cuda_gcn_torch.cli", "synth-pubmed",
                            "--prime-cache", "--compilation-cache", cache], cwd=root, env=env,
                           capture_output=True, text=True, timeout=600)
    prime_s = time.perf_counter() - t0
    built = sorted(os.listdir(os.path.join(cache, "kernels"))
                   + os.listdir(os.path.join(cache, "native")))
    primed = [line for line in prime.stdout.splitlines() if line.startswith("primed ")]
    log(f"  --prime-cache --compilation-cache (fresh): rc {prime.returncode} in {prime_s:.1f} s; "
        + "; ".join(primed))
    t0 = time.perf_counter()
    again = subprocess.run([sys.executable, "-c", _NO_COMPILER, "synth-pubmed",
                            "--compilation-cache", cache, "--epochs", "3"], cwd=root,
                           env=env, capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    after = sorted(os.listdir(os.path.join(cache, "kernels"))
                   + os.listdir(os.path.join(cache, "native")))
    log(f"  then --compilation-cache (same) --epochs 3 with the compilers refused: rc "
        f"{again.returncode} in {run_s:.1f} s; "
        + " | ".join(line for line in again.stdout.splitlines() if line.startswith("epoch=3")))
    programs = len(kernels.SOURCES) + len(native.SOURCES)
    if prime.returncode or again.returncode or after != built or len(primed) != programs + 1 \
            or not primed[-1].startswith(f"primed {programs} programs"):
        raise AssertionError(f"--prime-cache / --compilation-cache failed:\n{prime.stdout}"
                             f"{prime.stderr}\n{again.stdout}{again.stderr}")
    shutil.rmtree(cache, ignore_errors=True)
    return dict(prime_s=prime_s, run_s=run_s)


def _sharded_graph(pubmed):
    """World size 1 over NCCL, in this process: ``sharded.run_epochs_chunked``
    against ``sharded.run_epochs`` on synth-pubmed with bsr interiors."""
    import socket

    import torch
    import torch.distributed as dist

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.parallel import multihost, sharded

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"tcp://localhost:{port}", 1, 0, device="cuda")
    try:
        cfg, shards, _ = sharded.prepare_sharded(GCNConfig(graphsum_backend="bsr", seed=0),
                                                 pubmed, 1, device="cuda")
        inputs, truths = sharded.shard_inputs(cfg, shards[0], "cuda")
        e = GRAPH_SHARDED_EPOCHS
        runs = {}
        for way, fn in (("eager", sharded.run_epochs), ("graph", sharded.run_epochs_chunked)):
            state = sharded.create_state(cfg, "cuda", 0)
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = fn(state, inputs, truths[1], truths[2], cfg, e)
            torch.cuda.synchronize()
            runs[way] = dict(m=m.cpu(), state=state, launches=dict(kernels.launches),
                             ms=(time.perf_counter() - t0) * 1e3 / e)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    g, ea = runs["graph"], runs["eager"]
    agree = _compare("(r) sharded", dict(metrics=g["m"], **_state_leaves(g["state"])),
                     dict(metrics=ea["m"], **_state_leaves(ea["state"])))
    want = _expected_launches(e, 1)
    want = {k: v - 2 for k, v in want.items()}  # no test eval here
    log(f"  sharded, world size 1 over {backend}, synth-pubmed bsr interiors, {e} epochs: "
        f"graph against eager {agree}; {ea['ms']:.3f} against {g['ms']:.3f} ms/epoch "
        f"(whole calls); launches {g['launches']['bsr_tile']}/{g['launches']['csr_spmm']}"
        f", expected {want}")
    if backend != "nccl" or g["launches"] != ea["launches"] or any(
            g["launches"][k] != v for k, v in want.items()):
        raise AssertionError("the sharded graph's launches differ from the eager loop's")
    return dict(agree=agree, ms={"eager": ea["ms"], "graph": g["ms"]})


def phase_graphs(dataset):
    """(r) the epoch as a CUDA graph: synth-reddit bsr at full width and
    synth-pubmed pallas, 100 epochs at dropout 0.5, graph against eager
    (``_graph_against_eager``); early stopping on synth-pubmed ell; 2 + 2
    resumed through ``train.run``; ``--prime-cache`` and
    ``--compilation-cache`` across processes; the sharded graph at world
    size 1 over NCCL."""
    import numpy as np
    import torch

    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.data.graph import build_graph

    t_all = time.perf_counter()
    has = hasattr(torch.cuda.CUDAGraph, "register_generator_state")
    log(f"(r) epoch graphs: torch {torch.__version__}, "
        f"CUDAGraph.register_generator_state {'present' if has else 'MISSING'}")
    out = {}
    e = GRAPH_EPOCHS
    cfg = GCNConfig(epochs=e, graphsum_backend="bsr", reorder="none", seed=0)
    cfg, graph, x, truths = train.prepare(cfg, dataset, "cuda")
    out["synth-reddit bsr"] = _graph_against_eager(
        "synth-reddit bsr 602-16-41", graph, x, (truths[1], truths[2]), cfg, e,
        {"bsr_tile": 4 * e + 2, "csr_spmm": 4 * e + 2, "layer0_pair": e})
    del graph, x, truths
    torch.cuda.empty_cache()

    pubmed = load_cached("synth-pubmed")
    cfg = GCNConfig(epochs=e, graphsum_backend="pallas", seed=0)
    cfg, graph, x, truths = train.prepare(cfg, pubmed, "cuda")
    out["synth-pubmed pallas"] = _graph_against_eager(
        "synth-pubmed pallas 500-16-3", graph, x, (truths[1], truths[2]), cfg, e,
        {"ell_spmm": 4 * e + 2, "layer0_pair": e})
    es_cfg = GCNConfig(graphsum_backend="ell", seed=0, **GRAPH_ES)
    es_cfg, graph, x, truths = train.prepare(es_cfg, pubmed, "cuda")
    out["early stopping"] = _es_against_eager(graph, x, (truths[1], truths[2]), es_cfg)
    del graph, x, truths
    _resume_through_run(pubmed)
    out["prime"] = _prime_cli()
    out["sharded"] = _sharded_graph(pubmed)
    torch.cuda.empty_cache()
    log(f"  (r) took {time.perf_counter() - t_all:.1f} s; peak device memory so far "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    assert np.isfinite(out["synth-reddit bsr"]["run_ms"]["graph"])
    return out


# (s) the sharded graph across cards over NCCL (``python3 chip_smoke.py --nccl-graphs``)

NCCL_GRAPH_EPOCHS = 20
NCCL_GRAPH_ES = dict(epochs=40, early_stopping=3)


def _graph_rank(rank, world, init_method, cfg, shard):
    """(s), one NCCL rank on cuda:<rank>: ``sharded.run_epochs_chunked``
    against ``sharded.run_epochs`` and ``run_epochs_es_chunked`` against
    ``run_epochs_es``, each from a fresh state: metrics, state, launches and
    the halo rows and bytes shipped, and ms per epoch of the whole calls."""
    import dataclasses

    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.parallel import multihost, sharded

    device = torch.device("cuda", rank)
    multihost.initialize(init_method, world, rank, backend="nccl", device=device)
    torch.cuda.set_device(device)
    kernels.build()
    inputs, truths = sharded.shard_inputs(cfg, shard, device)
    # NCCL sets up its communicators at the first collective: not in a timed call
    sharded.run_epochs(sharded.create_state(cfg, device, rank), inputs, truths[1], truths[2],
                       cfg, 2)
    es_cfg = dataclasses.replace(cfg, **NCCL_GRAPH_ES)
    pairs = {
        "fused": (lambda st, f: f(st, inputs, truths[1], truths[2], cfg, NCCL_GRAPH_EPOCHS),
                  sharded.run_epochs, sharded.run_epochs_chunked),
        "early stopping": (lambda st, f: f(st, inputs, truths[1], truths[2], es_cfg,
                                           es_cfg.epochs, es_cfg.early_stopping),
                           sharded.run_epochs_es, sharded.run_epochs_es_chunked)}
    out = {}
    for name, (call, eager, graphed) in pairs.items():
        for way, fn in (("eager", eager), ("graph", graphed)):
            state = sharded.create_state(cfg, device, rank)
            kernels.reset_launches()
            sent = dict(inputs.exchange.sent)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = call(state, fn)
            m, stopped = res if isinstance(res, tuple) else (res, None)
            torch.cuda.synchronize()
            out[(name, way)] = dict(  # numpy: a rank's tensors would not outlive it
                metrics=m.cpu().numpy(), stopped=stopped,
                leaves={k: v.numpy() for k, v in _state_leaves(state).items()},
                launches=dict(kernels.launches),
                sent={k: v - sent[k] for k, v in inputs.exchange.sent.items()},
                ms=(time.perf_counter() - t0) * 1e3 / len(m))
    return out


def phase_nccl_graphs() -> dict:
    """(s) synth-reddit (bsr interiors, dropout 0.5, f32 halo) cut for every
    card of the machine, one NCCL rank a card: on every rank the graphed
    runners equal the eager ones bit for bit, with the same launches and the
    same halo rows and bytes, and the metrics agree across ranks."""
    import numpy as np
    import torch

    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.parallel import multihost, sharded

    def tensors(r):
        return {k: torch.from_numpy(v) for k, v in
                dict(metrics=r["metrics"], **r["leaves"]).items()}

    world = torch.cuda.device_count()
    if world < 2:
        raise AssertionError(f"--nccl-graphs needs 2 cards or more, have {world}")
    t0 = time.perf_counter()
    cfg, shards, _ = sharded.prepare_sharded(
        GCNConfig(graphsum_backend="bsr", seed=0, halo_dtype="float32"),
        load_cached("synth-reddit"), world, device="cuda")
    log(f"(s) synth-reddit cut for {world} NCCL ranks in {time.perf_counter() - t0:.1f} s; "
        f"dropout {cfg.dropout}, halo {cfg.halo_dtype}")
    ranks = multihost.run_ranks(_graph_rank, world, (cfg,), rank_args=[(s,) for s in shards],
                                timeout=600)
    summary = {}
    for name in ("fused", "early stopping"):
        for rank, r in enumerate(ranks):
            e, g = r[(name, "eager")], r[(name, "graph")]
            agree = _compare(f"(s) {name} rank {rank}", tensors(g), tensors(e))
            log(f"  {name}, rank {rank}: graph against eager {agree}; {len(g['metrics'])} "
                f"epochs (stopped {g['stopped']}); launches {g['launches']['bsr_tile']}/"
                f"{g['launches']['csr_spmm']} (eager {e['launches']['bsr_tile']}/"
                f"{e['launches']['csr_spmm']}); halo {g['sent']} (eager {e['sent']}); whole "
                f"calls {e['ms']:.3f} eager, {g['ms']:.3f} graph ms/epoch")
            if g["launches"] != e["launches"] or g["sent"] != e["sent"] \
                    or g["stopped"] != e["stopped"]:
                raise AssertionError(f"(s) {name}: rank {rank}'s graph ran other work")
            if not np.array_equal(g["metrics"], ranks[0][(name, "graph")]["metrics"]):
                raise AssertionError(f"(s) {name}: the ranks' metrics differ")
            summary[f"{name} rank {rank}"] = dict(agree=agree, eager_ms=e["ms"],
                                                  graph_ms=g["ms"])
    return summary


# (t) the benchmark entry, (u) the scaling bench: each in a process of its own

BENCH_EPOCHS = 100        # python -m cuda_gcn_torch.bench's default
SOL_FRACTION_MAX = 1.05   # a lower bound above 1 (beyond rounding) is a wrong model or clock


def _entry(module: str, *args: str, timeout: float) -> tuple[dict, str]:
    """``python -m <module> <args>`` from the repository's root: (its one stdout
    line as JSON, its stderr). Fails unless it exits 0 with exactly one line."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                         text=True, timeout=timeout)
    out = res.stdout.strip().splitlines()
    if res.returncode or len(out) != 1:
        raise AssertionError(f"{module} {' '.join(args)}: rc {res.returncode}, "
                             f"{len(out)} stdout lines:\n{res.stdout}\n{res.stderr[-4000:]}")
    return json.loads(out[0]), res.stderr


def phase_bench() -> dict:
    """(t) ``python -m cuda_gcn_torch.bench`` with its defaults (synth-reddit,
    bsr, 100 epochs, f32, on the card): its one line must have a positive
    ``value``, backend bsr, the card's name in ``device``, a speed-of-light
    lower bound in (0, 1.05] and a finite test accuracy; its measured run
    must launch kernels 1 and 2 on every pass, 4 · 100 + 2 each."""
    import math

    import torch

    t0 = time.perf_counter()
    doc, err = _entry("cuda_gcn_torch.bench", timeout=600)
    wall = time.perf_counter() - t0
    log(f"(t) python -m cuda_gcn_torch.bench in {wall:.1f} s: {json.dumps(doc)}")
    for line in err.splitlines():
        if line.startswith(("device:", "warmup", "total training time", "steady:",
                            "speed-of-light")):
            log(f"  {line}")
    d = doc.get("detail", {})
    sol = d.get("sol_fraction_lower_bound")
    launches = json.loads(err.split("kernel launches in the measured run: ")[1].splitlines()[0])
    want = 4 * BENCH_EPOCHS + 2
    if not (isinstance(doc.get("value"), (int, float)) and doc["value"] > 0
            and doc.get("metric") == f"synth-reddit_{BENCH_EPOCHS}ep_train_time"
            and d.get("backend") == "bsr"
            and torch.cuda.get_device_name(0) in str(d.get("device"))
            and isinstance(sol, (int, float)) and 0 < sol <= SOL_FRACTION_MAX
            and isinstance(d.get("test_acc"), (int, float)) and math.isfinite(d["test_acc"])):
        raise AssertionError(f"(t) the benchmark line fails its checks: {json.dumps(doc)}")
    if launches.get("bsr_tile") != want or launches.get("csr_spmm") != want:
        raise AssertionError(f"(t) kernels 1 and 2 launched {launches}, not {want} each")
    return dict(doc=doc, launches=launches, wall_s=wall)


def phase_bench_scaling() -> dict:
    """(u) ``python -m cuda_gcn_torch.bench_scaling --dataset reddit --parts
    1,2,4``, one NCCL rank a card: its partition statistics must equal the
    committed artifacts/partition_stats_reddit.json at P = 1, 2, 4, every P
    must be timed, and every rank must launch kernels 1 and 2."""
    import os

    t0 = time.perf_counter()
    doc, err = _entry("cuda_gcn_torch.bench_scaling", "--dataset", "reddit", "--parts",
                      "1,2,4", timeout=1500)
    log(f"(u) python -m cuda_gcn_torch.bench_scaling --dataset reddit --parts 1,2,4 in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in err.splitlines():
        if line.startswith(("P=", "  P=")):
            log(f"  {line.strip()}")
    log(f"  {json.dumps(doc)}")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "artifacts", "partition_stats_reddit.json")) as f:
        want = {r["parts"]: r for r in json.load(f)["results"]}
    got = {r["parts"]: r for r in doc["results"]}
    if sorted(got) != [1, 2, 4]:
        raise AssertionError(f"(u) timed P = {sorted(got)}, not 1, 2, 4")
    for p, r in got.items():
        if (r["partition"], r["boundary_fraction"]) != (want[p]["partition"],
                                                         want[p]["boundary_fraction"]):
            raise AssertionError(f"(u) P={p}: statistics {r} differ from the artifact's")
        if not r["seconds"] > 0:
            raise AssertionError(f"(u) P={p} was not timed: {r}")
    ranks = [json.loads(line.split("launches ")[1]) for line in err.splitlines()
             if line.startswith("  P=") and " launches " in line]
    if len(ranks) != 1 + 2 + 4 or not all(r.get("bsr_tile") and r.get("csr_spmm")
                                          for r in ranks):
        raise AssertionError(f"(u) the ranks' launches of kernels 1 and 2: {ranks}")
    return doc


# (v) the dense layer-0 kernel. Edge cases: (rows, F, H, dtype, rate, element
# offset of x in its buffer), each way (kernels.layer0_path). Flat: F = 67 and
# 5 (a warp's columns ending inside a group of 4, warps with none), H below
# 16, bf16, the correctly rounded division at rate 0.3, a last block of fewer
# than 32 rows. Chunked: F = 3,703 (58 chunks of W, more than one piece of
# shared memory at H = 16, and too wide for the wide way at H = 64, a launch
# per 16 columns); H 32, 41 and 100 with x off 16 bytes, bf16 rows 2 bytes
# off a 4-byte boundary (an offset of one element; at odd F every other
# row); row counts no multiple of 128. Wide: H 41 (32 bits a draw), 64 at bf16
# (8 bits a draw, both lanes of a row pair), 72 (a launch of 64 and one of 8),
# F = 67 at bf16 (a last chunk of 3 columns, rows 2 bytes off), F = 5 (one
# chunk of 5), last tiles of 9, 13 and 1 rows.
LAYER0_EDGES = (
    (1000, 67, 16, "float32", 0.5, 0), (70, 5, 16, "float32", 0.5, 0),
    (777, 602, 6, "float32", 0.3, 0), (1001, 602, 16, "bfloat16", 0.3, 0),
    (300, 3703, 16, "float32", 0.5, 0), (500, 602, 41, "bfloat16", 0.5, 1),
    (129, 101, 100, "bfloat16", 0.3, 1), (64, 602, 32, "float32", 0.5, 1),
    (333, 602, 16, "float32", 0.5, 2), (256, 500, 64, "bfloat16", 0.5, 0),
    (1, 1, 1, "float32", 0.5, 0), (200, 3703, 64, "float32", 0.6, 0),
    (1001, 602, 41, "float32", 0.6, 0), (333, 602, 72, "float32", 0.5, 0),
    (777, 67, 64, "bfloat16", 0.3, 0), (2049, 602, 64, "bfloat16", 0.6, 0),
    (70, 5, 33, "float32", 0.5, 0))
# (label, rows, F, H, dtype, rate): the GCN's layer 0 (H 16, p 0.5) and the GAT's (8 heads x 8, p 0.6)
LAYER0_SHAPES = (("synth-reddit", 232965, 602, 16, "float32", 0.5),
                 ("synth-reddit", 232965, 602, 16, "bfloat16", 0.5),
                 ("synth-pubmed", 19717, 500, 16, "float32", 0.5),
                 ("synth-reddit gat", 232965, 602, 64, "float32", 0.6))
LAYER0_ITERS = 20
LAYER0_IDLE_S = 0.1  # the idle time before a diagnostic trace in this process stops


def _layer0_inputs(n, f, h, dtype, offset, seed):
    """x [n, f] (3% of it nonzero, as synth-reddit's features; from element
    ``offset`` of its buffer), an f32 W scaled as Glorot's, and two int64 seeds
    drawn as the op draws them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.rand(offset + n * f, generator=gen, device="cuda")
    buf = torch.where(torch.rand(buf.shape, generator=gen, device="cuda") < 0.03, buf, 0.0)
    x = buf.to(getattr(torch, dtype))[offset:].view(n, f)
    w = torch.randn(f, h, generator=gen, device="cuda") * (2.0 / (f + h)) ** 0.5
    seeds = torch.empty(2, dtype=torch.int64, device="cuda").random_(generator=gen)
    return x, w, seeds


def _layer0_check(label, x, w, seeds, rate) -> dict:
    """The kernel against the plain version, on every row: each xd value 0 or
    x / (1 - p) correctly rounded, and nonzero only where x is; xd bit for bit
    the plain version's (its Philox mask); the keep share of x's nonzeros
    within 5 sigma of 1 - p; zt and ze against f64 products of the kernel's
    own xd and of x, within the f32 sums' bound (F·2^-23 of Σ|terms|) and one
    rounding to x's type, and for f32 x within ``ATOL``/``RTOL`` of the plain
    version's (for bf16 x one rounding to bf16 is itself far above them); the
    train-only launch and a second launch equal to the first bit for bit."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.ops.matmul import layer0_pair_plain

    xd, zt, ze = kernels.layer0_pair(x, w, seeds, rate, True)
    xd2, zt2, _ = kernels.layer0_pair(x, w, seeds, rate, False)
    torch.cuda.synchronize()
    q = kernels.dropout_keep(rate)[0]
    # a device tensor: ATen divides by it correctly rounded
    scaled = torch.where(xd != 0, x.float() / torch.tensor(q, device=x.device), 0.0).to(x.dtype)
    nz = x != 0
    if not torch.equal(xd, scaled) or int((xd[~nz] != 0).sum()):
        bad = int((xd != scaled).sum()) + int((xd[~nz] != 0).sum())
        raise AssertionError(f"(v) {label}: {bad} xd values are neither 0 nor x / (1 - p), "
                             f"or lie where x is 0")
    del scaled
    want_xd, want_zt, want_ze = layer0_pair_plain(x, w, seeds, rate, True)
    if not torch.equal(xd, want_xd):
        bad = int((xd != want_xd).sum())
        raise AssertionError(f"(v) {label}: xd differs from the plain version at {bad} elements")
    if x.dtype == torch.float32:
        for name, got, want in (("zt", zt, want_zt), ("ze", ze, want_ze)):
            if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
                err = float((got - want).abs().max())
                raise AssertionError(f"(v) {label}: {name} off the plain version's by {err:.3e}")
    del want_xd, want_zt, want_ze
    if not (torch.equal(xd, xd2) and torch.equal(zt, zt2)):
        raise AssertionError(f"(v) {label}: the train-only launch differs from the pair's")
    kept = int((xd != 0).sum())
    total = int(nz.sum())
    z = (kept - q * total) / max((q * (1 - q) * total) ** 0.5, 1e-30)
    if abs(z) > 5:
        raise AssertionError(f"(v) {label}: keep share {kept}/{total} reads {z:.2f} sigma")
    wr = w.to(x.dtype).double()
    unit = 2.0 ** -8 if x.dtype == torch.bfloat16 else 2.0 ** -24
    worst = 0.0
    for name, got, a in (("zt", zt, xd), ("ze", ze, x)):
        ref = a.double() @ wr
        tol = x.shape[1] * 2.0 ** -23 * (a.double().abs() @ wr.abs()) + unit * ref.abs() + 1e-30
        ratio = float(((got.double() - ref).abs() / tol).max()) if got.numel() else 0.0
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            raise AssertionError(f"(v) {label}: {name} off its f64 product, {ratio:.3f} of the bound")
    again = kernels.layer0_pair(x, w, seeds, rate, True)
    if not all(torch.equal(a, b) for a, b in zip(again, (xd, zt, ze))):
        raise AssertionError(f"(v) {label}: a second launch differs")
    path = kernels.layer0_path(x.shape[1], w.shape[1], x.element_size(), True, x.data_ptr())
    log(f"  {label} ({path}): every xd value 0 or x / (1 - p), equal to the plain version on "
        f"all {x.shape[0]} rows, keep {kept}/{total} "
        f"({z:+.2f} sigma), products at {worst:.3f} of their bound, repeatable, ok")
    return dict(keep_z=z, err_of_bound=worst)


def _layer0_graph_masks(seed: int = 11) -> None:
    """Through the op as training calls it: the mask of each of 3 epochs of an
    ``EpochGraph`` (eager, then capture and replays) equals the mask a fresh
    generator of the same seed draws eagerly, epoch by epoch, and consecutive
    epochs' masks differ."""
    import torch

    from cuda_gcn_torch import graphs
    from cuda_gcn_torch.ops.matmul import layer0_dense_pair

    x, w, _ = _layer0_inputs(19717, 500, 16, "float32", 0, 3)
    w.requires_grad_(True)
    seen = torch.zeros_like(x)

    def keep(t):
        if t.shape == x.shape:
            seen.copy_(t)
        return t

    def run(gen):
        def step():
            with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
                layer0_dense_pair(x, w, 0.5, gen, True)
        return step

    masks = {}
    for how in ("graph", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        step = run(gen)
        fn = graphs.EpochGraph(step, (gen,), ()).run if how == "graph" else step
        masks[how] = []
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            masks[how].append(seen != 0)
    same = [torch.equal(a, b) for a, b in zip(masks["graph"], masks["eager"])]
    differ = [not torch.equal(a, b) for a, b in zip(masks["graph"], masks["graph"][1:])]
    log(f"  a captured step and its replays draw the eager epochs' masks {same}; consecutive "
        f"epochs' masks differ {differ}")
    if not all(same) or not all(differ):
        raise AssertionError("(v) the graph's masks are not the eager epochs' fresh masks")


def _layer0_trace() -> None:
    """Prints, as one JSON line, ``_traces`` of the kernel's pair launch at
    each of ``LAYER0_SHAPES``. ``_own_process_launches`` runs it in a process
    of its own."""
    from cuda_gcn_torch import kernels

    calls = {}
    for label, n, f, h, dtype, rate in LAYER0_SHAPES:
        x, w, seeds = _layer0_inputs(n, f, h, dtype, 0, 7)
        calls[f"{label} {dtype}"] = (
            lambda x=x, w=w, seeds=seeds, rate=rate: kernels.layer0_pair(x, w, seeds, rate, True))
    print(json.dumps(_traces(calls)), flush=True)


def phase_layer0_pair() -> dict:
    """(v) the dense layer-0 kernel (csrc/layer0_pair.cu): checked against its
    plain version at ``LAYER0_EDGES`` and at full size, replays of a captured
    step against eager epochs, then timed at ``LAYER0_SHAPES`` beside its bound
    (bytes: x read once, xd written once, the products written once; 4·N·F·H
    f32 operations), the plain version and the six launches the model ran
    before (dropout's rand, compare, scale and where, and cuBLAS's two
    products). Its time by CUDA events, and on the device by the profiler in a
    process of its own (``_layer0_trace``); a device time below the bound is
    replaced by the events' and ``device_by`` says so. Traces in this process,
    stopped at once and after ``LAYER0_IDLE_S`` of idle, log the records they
    kept. ``launches`` counts this phase's launches alone."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.device import resolve_device
    from cuda_gcn_torch.ops.dropout import dropout
    from cuda_gcn_torch.ops.matmul import dense_matmul, layer0_dense_pair, layer0_pair_plain

    resolve_device("cuda")  # TF32 off for the yardstick and the f64-checked products
    log(f"(v) the dense layer-0 kernel; {_clocks()}")
    kernels.reset_launches()
    for i, (n, f, h, dtype, rate, offset) in enumerate(LAYER0_EDGES):
        x, w, seeds = _layer0_inputs(n, f, h, dtype, offset, 100 + i)
        _layer0_check(f"[{n}, {f}] x [{f}, {h}] {dtype} p={rate} at element {offset}",
                      x, w, seeds, rate)
    _layer0_graph_masks()
    rows = {}
    for label, n, f, h, dtype, rate in LAYER0_SHAPES:
        x, w, seeds = _layer0_inputs(n, f, h, dtype, 0, 7)
        key = f"{label} {dtype}"
        check = _layer0_check(key, x, w, seeds, rate)
        item = x.element_size()
        nbytes = 2 * n * f * item + 2 * n * h * item + 4 * f * h
        bound, by = _bound(nbytes, 4 * n * f * h)
        gen = torch.Generator(device="cuda").manual_seed(1)
        wg = w.clone().requires_grad_(True)
        fns = {
            "pair": lambda: kernels.layer0_pair(x, w, seeds, rate, True),
            "train": lambda: kernels.layer0_pair(x, w, seeds, rate, False),
            "op": lambda: layer0_dense_pair(x, wg, rate, gen, True, with_eval=True),
            "six_launches": lambda: (dense_matmul(dropout(x, rate, gen, True), w),
                                     dense_matmul(x, w)),
        }
        ms = {k: cuda_ms(fn, LAYER0_ITERS) for k, fn in fns.items()}
        ms["plain"] = cuda_ms(lambda: layer0_pair_plain(x, w, seeds, rate, True), 3)
        kept = {f"idle {idle} s": sum(n for n, _ in _kernel_records(fns["pair"], idle).values())
                for idle in (0.0, LAYER0_IDLE_S)}
        log(f"  {key}: traces in this process kept "
            + ", ".join(f"{n} of {PROFILED_CALLS} records ({k})" for k, n in kept.items()))
        rows[key] = dict(n=n, f=f, h=h, dtype=dtype, ms=ms["pair"], train_ms=ms["train"],
                         op_ms=ms["op"], bound_ms=bound, bound_by=by,
                         share_of_bound=bound / ms["pair"], plain_ms=ms["plain"],
                         library_ms=ms["six_launches"], records_in_process=kept, **check)
        log(f"  {key} [{n}, {f}] x [{f}, {h}]: pair {ms['pair']:.4f} ms, train half alone "
            f"{ms['train']:.4f}, the op with its seed draw {ms['op']:.4f}; bound {bound:.4f} ms "
            f"({by}, {nbytes / 1e9:.3f} GB): {100 * bound / ms['pair']:.1f}% of it; plain "
            f"version {ms['plain']:.3f} ms; dropout + two cuBLAS products "
            f"{ms['six_launches']:.4f} ms")
        del x, w, seeds, wg, fns
        torch.cuda.empty_cache()
    launches = kernels.launches["layer0_pair"]
    for key, row in _own_process_launches("_layer0_trace()").items():
        dev_us, by = row["trace_device_us"], "profiler"
        if dev_us < rows[key]["bound_ms"] * 1e3:
            log(f"  {key}: the profiler's {dev_us:.2f} us lie below the bound; events taken")
            dev_us, by = rows[key]["ms"] * 1e3, "events"
        rows[key].update(device_us=dev_us, device_by=by)
        log(f"  {key}: device {dev_us / 1e3:.4f} ms by the {by}")
    log(f"  {_clocks()}")
    return dict(rows=rows, launches=launches)


# (w) the GAT's attention kernels (csrc/gat_attention.cu): the paper's two
# layers on synth-reddit as (heads, features a head, floats a head in a row:
# the model pads 41 to 44), its dropout and slope; the output layer's rows
# unpadded as well, the layout the kernels took before the padding
GAT_SHAPES = ((8, 8, 8), (1, 41, 44))
GAT_UNPADDED = (1, 41, 41)
GAT_RATE, GAT_SLOPE = 0.6, 0.2
GAT_TOL = 1e-4     # of the largest |value| of the plain version: f32 sums in other orders
GAT_KEEP_SIGMA = 4.0
GAT_ITERS = 10
GAT_EPOCHS = 100   # a job of the benchmark's reddit cells
GAT_KERNELS = ("gat_forward", "gat_rows", "gat_cols")


def _gat_prepared():
    """synth-reddit as loaded, prepared for the GAT (the paper's settings, the
    ell backend, the reverse-edge map): (cfg, graph, x, truths)."""
    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached

    cfg = GCNConfig(model="gat", hidden_dim=8, dropout=GAT_RATE, learning_rate=0.005,
                    graphsum_backend="ell")
    return train.prepare(cfg, load_cached("synth-reddit"), "cuda")


def _gat_inputs(n, heads, fh, seed, ld=None):
    """z and g [n, K·LD] (LD = ``ld``, else F'; zeros past each head's F', as
    the model holds them) and the scores sl, sr [n, K] (normal), and two int64
    seeds drawn as the op draws them. The features do not depend on LD."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z, g = (torch.randn(n, heads * fh, generator=gen, device="cuda") for _ in range(2))
    sl, sr = (torch.randn(n, heads, generator=gen, device="cuda") for _ in range(2))
    seeds = torch.empty(2, dtype=torch.int64, device="cuda").random_(generator=gen)
    if ld is not None and ld != fh:
        z, g = (torch.nn.functional.pad(t.view(n, heads, fh), (0, ld - fh))
                .view(n, heads * ld) for t in (z, g))
    return z, sl, sr, g, seeds


def _gat_launch(emap, z, sl, sr, g, heads, rate, seeds):
    """The three launches of a training layer: (out, stats, node, dsl, dz, dsr)."""
    from cuda_gcn_torch import kernels

    out, stats = kernels.gat_forward(emap.plan, emap.partial_rows, z, sl, sr, heads, GAT_SLOPE,
                                     rate, seeds)
    node, dsl = kernels.gat_rows(emap.plan, emap.partial_rows, g, z, sl, sr, stats, heads,
                                 GAT_SLOPE, rate, seeds)
    dz, dsr = kernels.gat_cols(emap.plan_t, emap.partial_rows_t, emap.rev, g, z, sr, node,
                               heads, GAT_SLOPE, rate, seeds)
    return out, stats, node, dsl, dz, dsr


def _gat_digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: outputs equal bit for bit have
    equal digests across trees and calls."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _gat_check(label, emap, heads, fh, rate, seed, ld=None) -> float:
    """The three launches, z and g at LD = ``ld`` floats a head (zero past
    F'), against the plain version of the F' features (ops/attention.py, in
    ``plain_dtype``: f64 on a small graph, f32 at full size), each output
    within ``GAT_TOL`` of its largest value, the padding of out and dz 0, and
    a second run equal bit for bit. Returns the worst error over its
    tolerance."""
    import torch

    from cuda_gcn_torch.ops.attention import attention_backward_plain, attention_forward_plain

    n, ld = emap.plan.n_nodes, ld or fh
    z, sl, sr, g, seeds = _gat_inputs(n, heads, fh, seed, ld)
    seeds = seeds if rate > 0 else None
    got = _gat_launch(emap, z, sl, sr, g, heads, rate, seeds)
    again = _gat_launch(emap, z, sl, sr, g, heads, rate, seeds)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"(w) {label}: a second run differs")
    del again
    out, stats, node, dsl, dz, dsr = got
    for name, t in (("out", out), ("dz", dz)):
        if t.view(n, heads, ld)[..., fh:].any():
            raise AssertionError(f"(w) {label}: {name}'s padding is not 0")
    out, dz = (t.view(n, heads, ld)[..., :fh].reshape(n, heads * fh) for t in (out, dz))
    z, g = (t.view(n, heads, ld)[..., :fh].reshape(n, heads * fh) for t in (z, g))
    dt = torch.float64 if emap.plan.nnz < 5_000_000 else torch.float32
    want_out, want_stats = attention_forward_plain(emap, z.to(dt), sl.to(dt), sr.to(dt), heads,
                                                   GAT_SLOPE, rate, seeds)
    worst = 0.0
    pairs = [("out", out, want_out), ("max", stats[..., 0], want_stats[..., 0]),
             ("sum", stats[..., 1], want_stats[..., 1]), ("node.max", node[..., 1],
                                                          want_stats[..., 0])]
    del want_out
    want = attention_backward_plain(emap, g.to(dt), z.to(dt), sl.to(dt), sr.to(dt), want_stats,
                                    heads, GAT_SLOPE, rate, seeds)
    pairs += list(zip(("dz", "dsl", "dsr"), (dz, dsl, dsr), want))
    for name, a, b in pairs:
        ratio = float((a.double() - b.double()).abs().max()) / (
            GAT_TOL * max(float(b.double().abs().max()), 1e-30))
        worst = max(worst, ratio)
        if not ratio <= 1.0:
            raise AssertionError(f"(w) {label}: {name} off the plain version, {ratio:.3f} of "
                                 f"{GAT_TOL} of its largest value")
    log(f"  {label}: out, max, sum, dz, dsl, dsr within {worst:.3f} of {GAT_TOL} of the "
        f"plain version's largest values ({str(dt)[6:]}), padding 0, repeatable, ok")
    return worst


def _gat_keep_counts(emap, heads, seeds):
    """The kernel's kept weights of each row and head, read through the
    forward itself: z = 1 and zero scores make every weight 1/deg, so out·deg·q
    is the row's kept count. Returns (the kernel's counts, those of
    ``attention_keep``) [n, K], int64."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.ops.attention import attention_keep

    n = emap.plan.n_nodes
    z = torch.ones(n, heads, device="cuda")
    zero = torch.zeros(n, heads, device="cuda")
    out, _ = kernels.gat_forward(emap.plan, emap.partial_rows, z, zero, zero, heads, GAT_SLOPE,
                                 GAT_RATE, seeds, False)
    deg = torch.zeros(n, device="cuda")
    slot, row, _ = emap.edges()
    deg.index_add_(0, row, torch.ones(len(row), device="cuda"))
    q = kernels.gat_keep(GAT_RATE)[0]
    got = torch.round(out.double() * deg.double()[:, None] * q).long()
    want = torch.zeros(n, heads, dtype=torch.int64, device="cuda")
    s = seeds.tolist()
    for a in range(0, len(slot), 1 << 22):
        keep = attention_keep(s, slot[a:a + (1 << 22)], heads, GAT_RATE)
        want.index_add_(0, row[a:a + (1 << 22)], keep.long())
    return got, want


def _gat_masks(emap) -> dict:
    """Every head's keep share over synth-reddit's slots, read from the
    kernel, within ``GAT_KEEP_SIGMA`` of 1 - p and equal row by row to
    ``attention_keep``'s; and the masks of 3 epochs of an ``EpochGraph``
    (eager, then capture and replays) equal to eager draws of the same seed
    and fresh each epoch."""
    import torch

    from cuda_gcn_torch import graphs, kernels
    from cuda_gcn_torch.ops.attention import attention

    q = kernels.gat_keep(GAT_RATE)[0]
    shares = {}
    for heads, _, _ in GAT_SHAPES:
        seeds = torch.empty(2, dtype=torch.int64, device="cuda").random_(
            generator=torch.Generator(device="cuda").manual_seed(heads))
        got, want = _gat_keep_counts(emap, heads, seeds)
        if not torch.equal(got, want):
            raise AssertionError(f"(w) K={heads}: the kernel's kept counts differ from "
                                 f"attention_keep's in {int((got != want).sum())} row-heads")
        total = emap.plan.nnz
        kept = got.sum(0).tolist()
        zs = [(k - q * total) / (q * (1 - q) * total) ** 0.5 for k in kept]
        shares[f"K={heads}"] = dict(kept=kept, slots=total, z=zs)
        log(f"  K={heads}: keep share by head {[round(k / total, 6) for k in kept]} of "
            f"{total} slots, {max(abs(v) for v in zs):.2f} sigma at most; equal to "
            f"attention_keep row by row")
        if max(abs(v) for v in zs) > GAT_KEEP_SIGMA:
            raise AssertionError(f"(w) K={heads}: a keep share lies {max(map(abs, zs)):.2f} "
                                 f"sigma from {q}")
    n, heads = emap.plan.n_nodes, 8
    z = torch.ones(n, heads, device="cuda")
    zero = torch.zeros(n, heads, device="cuda")
    seen = torch.zeros(n, heads, device="cuda")

    def run(gen):
        def step():
            seen.copy_(attention(z, zero, zero, emap, heads, GAT_SLOPE, GAT_RATE, gen, True))
        return step

    masks = {}
    for how in ("graph", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(5)
        step = run(gen)
        fn = graphs.EpochGraph(step, (gen,), ()).run if how == "graph" else step
        masks[how] = []
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            masks[how].append(seen.clone())
    same = [torch.equal(a, b) for a, b in zip(masks["graph"], masks["eager"])]
    differ = [not torch.equal(a, b) for a, b in zip(masks["graph"], masks["graph"][1:])]
    log(f"  a captured attention and its replays draw the eager epochs' masks {same}; "
        f"consecutive epochs' masks differ {differ}")
    if not all(same) or not all(differ):
        raise AssertionError("(w) the graph's attention masks are not fresh eager draws")
    return shares


def _gat_bytes(emap, heads, fh) -> dict:
    """Each launch's least bytes: its inputs read once and its outputs written
    once (the columns and the row pointers of its plan, [n, K·F'] and [n, K]
    tensors; the column pass also reads the reverse map)."""
    n, d = emap.plan.n_nodes, heads * fh
    index = 4 * emap.plan.nnz + 4 * (n + 1)
    nd, nk = 4 * n * d, 4 * n * heads
    return {"gat_forward": index + 2 * nd + 2 * nk + 2 * nk,
            "gat_rows": index + 2 * nd + 4 * nk + 4 * nk + nk,
            "gat_cols": index + 4 * emap.plan_t.nnz + 2 * nd + nk + 4 * nk + nd + nk}


def _gat_trace() -> None:
    """Prints, as one JSON line, ``_traces`` of each launch at the paper's
    hidden layer on synth-reddit. ``_own_process_launches`` runs it in a
    process of its own."""
    from cuda_gcn_torch import kernels

    _, graph, _, _ = _gat_prepared()
    emap = graph.edge_map
    heads, fh, _ = GAT_SHAPES[0]
    z, sl, sr, g, seeds = _gat_inputs(emap.plan.n_nodes, heads, fh, 3)
    out, stats, node, *_ = _gat_launch(emap, z, sl, sr, g, heads, GAT_RATE, seeds)
    print(json.dumps(_traces({
        "gat_forward": lambda: kernels.gat_forward(emap.plan, emap.partial_rows, z, sl, sr,
                                                   heads, GAT_SLOPE, GAT_RATE, seeds),
        "gat_rows": lambda: kernels.gat_rows(emap.plan, emap.partial_rows, g, z, sl, sr, stats,
                                             heads, GAT_SLOPE, GAT_RATE, seeds),
        "gat_cols": lambda: kernels.gat_cols(emap.plan_t, emap.partial_rows_t, emap.rev, g, z,
                                             sr, node, heads, GAT_SLOPE, GAT_RATE, seeds)})),
          flush=True)


def _gat_device_us() -> dict:
    """The device us a call of each launch, from ``_gat_trace`` in a process
    of its own: a launch is its item kernel and, where rows are split, the
    partials' kernel, each with ``PROFILED_CALLS`` records."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    res = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke._gat_trace()"],
                         cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                         text=True, timeout=600)
    if res.returncode:
        raise AssertionError(f"the trace _gat_trace(): rc {res.returncode}\n{res.stderr[-4000:]}")
    out = {}
    for kernel, traces in json.loads(res.stdout.strip().splitlines()[-1]).items():
        last = traces[-1]
        log(f"  {kernel}: " + "; ".join(f"{name}: {n} records, {us / max(n, 1):.2f} us each"
                                        for name, (n, us) in last.items()))
        if not 1 <= len(last) <= 2 or any(n != PROFILED_CALLS for n, _ in last.values()):
            raise AssertionError(f"{kernel}: the trace did not hold its kernels once a call: "
                                 f"{last}")
        out[kernel] = {"kernels": len(last),
                       "device_us": sum(us for _, us in last.values()) / PROFILED_CALLS}
    return out


def phase_gat() -> dict:
    """(w) the GAT's attention kernels: checked against their plain version
    on synth-pubmed (f64; five layer shapes) and at full size on synth-reddit
    (f32; its rows of up to 43,403 slots split into chunks),
    both layers' shapes (the output layer's 41 floats a head padded to 44, and
    unpadded), with and without dropout; the kernel's masks read back (keep
    shares, ``attention_keep`` row by row, fresh under replays); each launch
    timed by events beside its bytes bound, layer by layer, and on the device
    in a process of its own; the digest of the hidden layer's outputs, which
    the padding leaves bit for bit; then a 100-epoch GAT job through the
    trainer: its launches an epoch and their lane splits, its epoch time and
    its peak memory."""
    import dataclasses

    import torch

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.device import resolve_device

    resolve_device("cuda")
    log(f"(w) the GAT's attention kernels; {_clocks()}")
    small = train.prepare(GCNConfig(model="gat", hidden_dim=8), load_cached("synth-pubmed"),
                          "cuda")[1].edge_map
    for heads, fh, ld in GAT_SHAPES + (GAT_UNPADDED, (3, 5, 8), (1, 7, 8)):
        for rate in (0.0, GAT_RATE):
            _gat_check(f"synth-pubmed K={heads} F'={fh} LD={ld} p={rate}", small, heads, fh,
                       rate, 1, ld)
    t0 = time.perf_counter()
    cfg, graph, x, truths = _gat_prepared()
    emap = graph.edge_map
    log(f"  synth-reddit prepared for the GAT in {time.perf_counter() - t0:.1f} s "
        f"({emap.plan.n_partials} partials of {emap.plan.split_rows.numel()} split rows)")
    worst = {}
    for heads, fh, ld in GAT_SHAPES + (GAT_UNPADDED,):
        for rate in (0.0, GAT_RATE):
            worst[f"K={heads} LD={ld} p={rate}"] = _gat_check(
                f"synth-reddit K={heads} F'={fh} LD={ld} p={rate}", emap, heads, fh, rate, 2, ld)
    torch.cuda.empty_cache()
    shares = _gat_masks(emap)
    heads, fh, _ = GAT_SHAPES[0]
    z, sl, sr, g, seeds = _gat_inputs(emap.plan.n_nodes, heads, fh, 3)
    digest = _gat_digest(_gat_launch(emap, z, sl, sr, g, heads, GAT_RATE, seeds))
    del z, sl, sr, g
    log(f"  K={heads} F'={fh}: digest of out, stats, node, dsl, dz, dsr at seed 3: {digest}")
    rows = {}
    for heads, fh, ld in GAT_SHAPES + (GAT_UNPADDED,):
        z, sl, sr, g, seeds = _gat_inputs(emap.plan.n_nodes, heads, fh, 3, ld)
        out, stats, node, *_ = _gat_launch(emap, z, sl, sr, g, heads, GAT_RATE, seeds)
        fns = {
            "gat_forward": lambda: kernels.gat_forward(emap.plan, emap.partial_rows, z, sl, sr,
                                                       heads, GAT_SLOPE, GAT_RATE, seeds),
            "gat_forward eval": lambda: kernels.gat_forward(
                emap.plan, emap.partial_rows, z, sl, sr, heads, GAT_SLOPE, 0.0, None, False),
            "gat_rows": lambda: kernels.gat_rows(emap.plan, emap.partial_rows, g, z, sl, sr,
                                                 stats, heads, GAT_SLOPE, GAT_RATE, seeds),
            "gat_cols": lambda: kernels.gat_cols(emap.plan_t, emap.partial_rows_t, emap.rev, g,
                                                 z, sr, node, heads, GAT_SLOPE, GAT_RATE, seeds)}
        nbytes = _gat_bytes(emap, heads, fh)
        for name, fn in fns.items():
            split = kernels.gat_layout(heads, ld, z.data_ptr(), out.data_ptr(),
                                       wide=not name.startswith("gat_forward"))
            ms = cuda_ms(fn, GAT_ITERS)
            b = nbytes[name.split()[0]] - (8 * emap.plan.n_nodes * heads if "eval" in name
                                           else 0)
            bound = b / PEAK_BYTES_PER_S * 1e3
            rows[f"{name} K={heads} F'={fh} LD={ld}"] = dict(ms=ms, bound_ms=bound, bytes=b,
                                                             split=split)
            log(f"  {name} K={heads} F'={fh} LD={ld} (VEC, L2, G, STEPS {split}): {ms:.4f} ms, "
                f"bound {bound:.4f} ms ({b / 1e9:.3f} GB): {100 * bound / ms:.1f}% of it")
        del z, sl, sr, g, out, stats, node, fns
        torch.cuda.empty_cache()
    for heads, fh, ld in GAT_SHAPES + (GAT_UNPADDED,):
        layer = sum(rows[f"{n} K={heads} F'={fh} LD={ld}"]["ms"] * times
                    for n, times in (("gat_forward", 1), ("gat_forward eval", 1),
                                     ("gat_rows", 1), ("gat_cols", 1)))
        log(f"  a layer's four launches at K={heads} F'={fh} LD={ld}: {layer:.4f} ms an epoch")
    device = _gat_device_us()
    for name, d in device.items():
        log(f"  {name} K=8 F'=8: device {d['device_us'] / 1e3:.4f} ms a call "
            f"({d['kernels']} kernels)")
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    times = []
    for seed in (1, 2):
        state = train.create_state(dataclasses.replace(cfg, seed=seed), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=GAT_EPOCHS,
                                     **kw)
        test = train.eval_step(state.model, graph, x, truths[3], weight_decay=cfg.weight_decay)
        rows_m = m.cpu()
        test_loss = float(test[0])
        times.append((time.perf_counter() - t0) * 1e3 / GAT_EPOCHS)
        log(f"  a {GAT_EPOCHS}-epoch GAT job (seed {seed}): {times[-1]:.3f} ms an epoch, first "
            f"and last train loss {float(rows_m[0, 0]):.5f} {float(rows_m[-1, 0]):.5f}, last "
            f"val acc {float(rows_m[-1, 3]):.5f}, test loss {test_loss:.5f}")
        if not bool(torch.isfinite(rows_m).all()):
            raise AssertionError("(w) the GAT job's metrics are not finite")
        del state
    launches = dict(kernels.launches)
    want = {"gat_forward": 2 * (4 * GAT_EPOCHS + 2 + 2), "gat_rows": 2 * 2 * GAT_EPOCHS,
            "gat_cols": 2 * 2 * GAT_EPOCHS, "layer0_pair": 2 * GAT_EPOCHS}
    got = {k: launches[k] for k in want}
    log(f"  launches of two jobs: {got} (expected {want}); peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if got != want:
        raise AssertionError(f"(w) the GAT jobs' launches {got} are not {want}")
    # each layer half of every launch: 8 x 8 at one lane a head, 1 x 41 padded
    # to 44 at 8 lanes of 2 float4 in the forward, 4 lanes of 4 in the backward
    want_splits = {(k, 4, 1, 2): got[k] // 2 for k in GAT_KERNELS}
    want_splits.update({(k, 4, 8, 2) if k == "gat_forward" else (k, 4, 4, 4): got[k] // 2
                        for k in GAT_KERNELS})
    log(f"  lane splits (launcher, VEC, L2, STEPS) of the jobs' launches: "
        f"{dict(kernels.gat_layouts)}")
    if kernels.gat_layouts != want_splits:
        raise AssertionError(f"(w) the GAT jobs' splits {kernels.gat_layouts} are not "
                             f"{want_splits}")
    log(f"  {_clocks()}")
    return dict(rows=rows, device=device, worst=worst, shares=shares, epoch_ms=times,
                launches=got, splits={",".join(map(str, k)): v
                                      for k, v in kernels.gat_layouts.items()},
                digest=digest, peak_gib=torch.cuda.max_memory_allocated() / 2**30)


# (x) kernel 3's blended form and GCNII (models/gcnii.py) at the paper's 64
# layers of 64 on synth-reddit
GCNII_WIDTH, GCNII_LAYERS, GCNII_ALPHA = 64, 64, 0.1
GCNII_ITERS = 20
GCNII_EPOCHS = 20


def _blend_bytes(plan, d: int, with_h0: bool) -> int:
    """A blended pass's least bytes: columns and coefficients once, h read,
    h0 read where given, out written (f32)."""
    return 8 * plan.nnz + 4 * plan.n_nodes * d * (3 if with_h0 else 2)


def phase_gcnii() -> dict:
    """(x) kernel 3's blended form and GCNII through the trainer."""
    import dataclasses

    import torch

    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.dataset import load_cached
    from cuda_gcn_torch.device import resolve_device
    from cuda_gcn_torch.ops import blend as tblend
    from cuda_gcn_torch.ops.ell import ell_spmm

    resolve_device("cuda")
    log(f"(x) kernel 3's blended form and GCNII; {_clocks()}")
    cfg = GCNConfig(model="gcnii", hidden_dim=GCNII_WIDTH, layers=GCNII_LAYERS, dropout=0.6,
                    learning_rate=0.01, graphsum_backend="ell")
    t0 = time.perf_counter()
    cfg, graph, x, truths = train.prepare(cfg, load_cached("synth-reddit"), "cuda")
    plan = graph.ell
    log(f"  synth-reddit prepared for GCNII in {time.perf_counter() - t0:.1f} s "
        f"({plan.n_partials} partials of {plan.split_rows.numel()} split rows)")
    n, d = plan.n_nodes, GCNII_WIDTH
    gen = torch.Generator(device="cuda").manual_seed(4)
    h, h0, he, h0e = (torch.randn(n, d, device="cuda", generator=gen) for _ in range(4))
    a, b = 1.0 - GCNII_ALPHA, GCNII_ALPHA
    cat = torch.cat([h, he], dim=1)

    def launch(name):
        if name == "single":
            return kernels.ell_blend(plan.work_beg, plan.work_len, plan.work_dst,
                                     plan.split_rows, plan.split_ptr, plan.cols, plan.coef, h,
                                     h0, n, plan.n_partials, a, b)
        if name == "scaled":
            return kernels.ell_blend(plan.work_beg, plan.work_len, plan.work_dst,
                                     plan.split_rows, plan.split_ptr, plan.cols, plan.coef, h,
                                     None, n, plan.n_partials, a, 0.0)
        return kernels.ell_blend(plan.work_beg, plan.work_len, plan.work_dst, plan.split_rows,
                                 plan.split_ptr, plan.cols, plan.coef, cat, (h0, h0e), n,
                                 plan.n_partials, a, b, halves=2)

    plain = {"single": lambda: tblend.blend_plain(plan, h, (h0,), a, b),
             "scaled": lambda: tblend.blend_plain(plan, h, None, a, 0.0),
             "pair": lambda: torch.cat(tblend.blend_plain(plan, cat, (h0, h0e), a, b, 2), 1)}
    rows = {}
    for name in ("single", "scaled", "pair"):
        got = launch(name)
        got = torch.cat(got, 1) if name == "pair" else got
        again = launch(name)
        again = torch.cat(again, 1) if name == "pair" else again
        if not torch.equal(got, again):
            raise AssertionError(f"(x) {name}: a second launch differs")
        check(f"(x) ell_blend {name} against its plain version", got, plain[name]())
        width = 2 * d if name == "pair" else d
        nbytes = _blend_bytes(plan, width, name != "scaled")
        ms = cuda_ms(lambda: launch(name), GCNII_ITERS)
        device_us = _device_us(lambda: launch(name))
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        rows[name] = dict(ms=ms, device_us=device_us, bound_ms=bound, bytes=nbytes, d=width)
        log(f"  ell_blend {name} at d = {width}: {ms:.4f} ms (device {device_us / 1e3:.4f} ms), "
            f"bound {bound:.4f} ms ({nbytes / 1e9:.3f} GB): {100 * bound / ms:.1f}% of it")
    ones = kernels.ell_blend(plan.work_beg, plan.work_len, plan.work_dst, plan.split_rows,
                             plan.split_ptr, plan.cols, plan.coef, h, None, n, plan.n_partials,
                             1.0, 0.0)
    if not torch.equal(ones, ell_spmm(plan, h)):
        raise AssertionError("(x) ell_blend at a = 1 without h0 is not kernel 3's pass")
    log("  ell_blend at a = 1 without h0: kernel 3's pass bit for bit")
    spmm_ms = {w: cuda_ms(lambda t=t: ell_spmm(plan, t), GCNII_ITERS)
               for w, t in ((d, h), (2 * d, cat))}
    log(f"  kernel 3 alone on the same rows: d = {d} {spmm_ms[d]:.4f} ms, d = {2 * d} "
        f"{spmm_ms[2 * d]:.4f} ms")
    del h, h0, he, h0e, cat, ones
    torch.cuda.empty_cache()

    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    runs = {}
    for way in ("eager", "graph"):
        state = train.create_state(dataclasses.replace(cfg, seed=5), "cuda")
        if way == "eager":
            m = train.run_epochs(state, graph, x, truths[1], truths[2], epochs=3, **kw)
        else:
            m = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=3, **kw)
        runs[way] = dict(metrics=m.cpu(), **_state_leaves(state))
        del state
    agree = _compare("(x) GCNII graph against eager", runs["graph"], runs["eager"])
    log(f"  GCNII 3 epochs, graph against eager: {agree}")
    if agree != "bit for bit":
        raise AssertionError(f"(x) GCNII's graph is not the eager loop bit for bit: {agree}")
    del runs
    torch.cuda.empty_cache()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state = train.create_state(dataclasses.replace(cfg, seed=6), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=GCNII_EPOCHS,
                                 **kw).cpu()
    test_loss, _ = train.eval_step(state.model, graph, x, truths[3],
                                   weight_decay=cfg.weight_decay)
    test_loss = float(test_loss)
    job_ms = (time.perf_counter() - t0) * 1e3 / GCNII_EPOCHS
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: v for k, v in kernels.launches.items() if v}
    want = {"ell_blend": 2 * GCNII_LAYERS * GCNII_EPOCHS + 2 * GCNII_LAYERS,
            "layer0_pair": GCNII_EPOCHS, "gcnii_epilogue": GCNII_LAYERS * GCNII_EPOCHS,
            "gcnii_epilogue_bwd": GCNII_LAYERS * GCNII_EPOCHS}
    log(f"  a {GCNII_EPOCHS}-epoch GCNII job: {job_ms:.3f} ms an epoch, first and last train "
        f"loss {float(m[0, 0]):.5f} {float(m[-1, 0]):.5f}, test loss {test_loss:.5f}; "
        f"launches {launches} (expected {want}); peak allocated {peak:.3f} GiB")
    if not bool(torch.isfinite(m).all()) or float(m[-1, 0]) >= float(m[0, 0]):
        raise AssertionError("(x) the GCNII job's loss is not finite or did not fall")
    if launches != want:
        raise AssertionError(f"(x) the GCNII job's launches {launches} are not {want}")
    log(f"  {_clocks()}")
    return dict(rows=rows, spmm_ms=spmm_ms, agree=agree, epoch_ms=job_ms, launches=launches,
                peak_gib=peak)


# (y) GCNII's convolution epilogue (csrc/gcnii_epilogue.cu) at synth-reddit's
# rows, GCNII's width, its first convolution's θ and its dropout
EPILOGUE_ROWS, EPILOGUE_RATE = 232965, 0.6
EPILOGUE_ITERS = 50


def _epilogue_inputs(n, h, seed):
    """st, se [n, h] (the blended passes' scale), g [n, h], W [h, h] as GCNII
    draws it, and two int64 seeds drawn as the op draws them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    st, se, g = (torch.randn(n, h, generator=gen, device="cuda") for _ in range(3))
    w = (torch.rand(h, h, generator=gen, device="cuda") * 2 - 1) * h ** -0.5
    seeds = torch.empty(2, dtype=torch.int64, device="cuda").random_(generator=gen)
    return st, se, g, w, seeds


def _epilogue_tol(s, w, theta):
    """Per element, the bound of an f32 epilogue's z off the f64 one: the FMA
    chain's h·2^-23 of θ·Σ|terms|, and 2^-21 of θ·|s·W| + |s| for the f32
    constants θ and 1 - θ, the rounding of each term, of z and of the scaled z."""
    return (theta * s.shape[1] * 2.0 ** -23 * (s.double().abs() @ w.double().abs())
            + 2.0 ** -21 * (theta * (s.double() @ w.double()).abs() + s.double().abs()) + 1e-30)


def _epilogue_check(st, se, g, w, seeds, theta, rate) -> dict:
    """Both kernels against their plain version and against ATen on the card:
    the mask bit for bit ``gcnii_keep``'s, its keep share within 5 sigma of
    1 - p; ht, he within ``_epilogue_tol`` of the f64 epilogue (ReLU's sign
    free only where z lies within it of 0); the training half at p equal bit
    for bit to ATen's dropout of the same launch's half at p = 0; gz bit for bit
    ATen's chain of the kernel's own mask and bits; gs within the bound of
    the f64 product of that gz; every launch repeatable bit for bit, both
    layouts of the output equal."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.ops.epilogue import gcnii_keep, unpack_bits

    n, h = st.shape
    ht, he, keep, relu = kernels.gcnii_epilogue(st, se, w, seeds, theta, rate, True)
    apart = kernels.gcnii_epilogue(st, se, w, seeds, theta, rate, False)
    again = kernels.gcnii_epilogue(st, se, w, seeds, theta, rate, True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((ht, he, keep, relu), apart)) or \
            not all(torch.equal(a, b) for a, b in zip((ht, he, keep, relu), again)):
        raise AssertionError("(y) the epilogue's launches differ (concat, apart, again)")
    if not torch.equal(keep, gcnii_keep(seeds.tolist(), n, h, rate, "cuda")):
        raise AssertionError("(y) the epilogue's mask is not gcnii_keep's")
    q = 1.0 - rate
    kept = int(keep.sum())
    z_keep = (kept - q * keep.numel()) / (q * (1 - q) * keep.numel()) ** 0.5
    if abs(z_keep) > 5:
        raise AssertionError(f"(y) keep share {kept}/{keep.numel()} reads {z_keep:.2f} sigma")
    pos = unpack_bits(relu, h)
    worst, flips = 0.0, 0
    for name, got, s, train in (("ht", ht, st, True), ("he", he, se, False)):
        z = theta * (s.double() @ w.double()) + (1 - theta) * s.double()
        tol = _epilogue_tol(s, w, theta)
        near = z.abs() <= tol
        if train:
            flips = int(((z > 0) != pos)[~near].sum())
            if flips:
                raise AssertionError(f"(y) ReLU's bits differ from the f64 sign at {flips} "
                                     f"elements away from 0")
            scale = kernels.gcnii_dropout(rate)[0]
            want, got_z = torch.where(keep, z.clamp_min(0) * scale, 0.0), got.double()
            tol = tol * scale
        else:
            want, got_z = z.clamp_min(0), got.double()
        ratio = ((got_z - want).abs() / tol)[~near]
        worst = max(worst, float(ratio.max()))
        del z, tol, near, want, got_z
    if not worst <= 1.0:
        raise AssertionError(f"(y) the epilogue's outputs lie {worst:.3f} of their bound off f64")
    # the dropout as ATen takes it on the card, from the same launch at p = 0
    h0t, _, keep0, relu0 = kernels.gcnii_epilogue(st, se, w, seeds, theta, 0.0, True)
    if not bool(keep0.all()) or not torch.equal(relu0, relu):
        raise AssertionError("(y) at p = 0 the epilogue drops an element or moves ReLU's bits")
    aten = torch.where(keep, h0t / (1.0 - rate), torch.zeros((), device="cuda"))
    reciprocal = torch.equal(st / (1.0 - rate), st * kernels.gcnii_dropout(rate)[0])
    if not torch.equal(ht, aten):
        raise AssertionError(f"(y) the kept values differ from ATen's x / (1 - p) at "
                             f"{int((ht != aten).sum())} elements (ATen multiplies by the "
                             f"f32 reciprocal: {reciprocal})")
    del h0t, keep0, relu0, aten
    gs, gz = kernels.gcnii_epilogue_bwd(g, keep, relu, w, theta, rate)
    gs2, gz2 = kernels.gcnii_epilogue_bwd(g, keep, relu, w, theta, rate)
    want_gz = torch.where(pos, torch.where(keep, g, 0.0) / (1.0 - rate), 0.0)
    if not (torch.equal(gs, gs2) and torch.equal(gz, gz2)) or not torch.equal(gz, want_gz):
        raise AssertionError("(y) the backward's gz is not ATen's chain bit for bit, or a "
                             "second launch differs")
    ref = theta * (gz.double() @ w.double().t()) + (1 - theta) * gz.double()
    tol = _epilogue_tol(gz, w.t(), theta)
    bwd_ratio = float(((gs.double() - ref).abs() / tol).max())
    if not bwd_ratio <= 1.0:
        raise AssertionError(f"(y) gs lies {bwd_ratio:.3f} of its bound off f64")
    err = {"ht": float((ht.double() - torch.where(keep & pos, (theta * (st.double() @ w.double())
                                                               + (1 - theta) * st.double())
                                                  * kernels.gcnii_dropout(rate)[0], 0.0))
                      .abs().max()),
           "gs": float((gs.double() - ref).abs().max())}
    log(f"  [{n}, {h}] p={rate} theta={theta:.6f}: mask gcnii_keep's bit for bit, keep "
        f"{kept}/{keep.numel()} ({z_keep:+.2f} sigma); ht, he at {worst:.3f} of their f64 bound "
        f"(max |ht - f64| {err['ht']:.3e}); kept values ATen's x / (1 - p) of the p = 0 launch "
        f"bit for bit (ATen's scalar division is the f32 reciprocal's product: {reciprocal}); gz "
        f"ATen's chain bit for bit, gs at {bwd_ratio:.3f} of its bound (max |gs - f64| "
        f"{err['gs']:.3e}); repeatable, both layouts equal, ok")
    return dict(keep_z=z_keep, err_of_bound=worst, bwd_err_of_bound=bwd_ratio,
                max_abs_err=err, aten_reciprocal=reciprocal)


def _epilogue_graph_masks(seed: int = 11) -> None:
    """Through the op as training calls it: each of 3 epochs of an
    ``EpochGraph`` (eager, then capture and replays) draws the mask that a
    fresh generator of the same seed draws eagerly, epoch by epoch, and
    consecutive epochs' masks differ."""
    import torch

    from cuda_gcn_torch import graphs
    from cuda_gcn_torch.ops.epilogue import gcnii_epilogue

    st, se, _, w, _ = _epilogue_inputs(19717, 64, 3)
    seen = torch.zeros(st.shape, dtype=torch.bool, device="cuda")

    def keep(t):
        if t.dtype == torch.bool and t.shape == st.shape:
            seen.copy_(t)
        return t

    def run(gen):
        def step():
            with torch.autograd.graph.saved_tensors_hooks(keep, lambda t: t):
                gcnii_epilogue(st.requires_grad_(True), se, w, 0.4, EPILOGUE_RATE, gen, True)
        return step

    masks = {}
    for how in ("graph", "eager"):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        step = run(gen)
        fn = graphs.EpochGraph(step, (gen,), ()).run if how == "graph" else step
        masks[how] = []
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            masks[how].append(seen.clone())
    same = [torch.equal(a, b) for a, b in zip(masks["graph"], masks["eager"])]
    differ = [not torch.equal(a, b) for a, b in zip(masks["graph"], masks["graph"][1:])]
    log(f"  a captured epilogue and its replays draw the eager epochs' masks {same}; "
        f"consecutive epochs' masks differ {differ}")
    if not all(same) or not all(differ):
        raise AssertionError("(y) the graph's masks are not the eager epochs' fresh masks")


def phase_gcnii_epilogue() -> dict:
    """(y) GCNII's convolution epilogue (csrc/gcnii_epilogue.cu): both kernels
    against their plain version and ATen at synth-reddit's rows, a captured
    launch's replays against eager epochs, then each kernel timed by events
    and on the device (the profiler) beside its bound (bytes, or the f32
    FMAs) and beside the ATen chain it replaced (``library_ms``), forward
    alone and forward with backward; the launch counters of a training epoch
    are phase (x)'s."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.device import resolve_device
    from cuda_gcn_torch.models.gcnii import theta as theta_of
    from cuda_gcn_torch.ops.dropout import dropout
    from cuda_gcn_torch.ops.epilogue import gcnii_epilogue

    resolve_device("cuda")
    log(f"(y) GCNII's convolution epilogue; {_clocks()}")
    n, h, rate = EPILOGUE_ROWS, GCNII_WIDTH, EPILOGUE_RATE
    st, se, g, w, seeds = _epilogue_inputs(n, h, 1)
    checks = {}
    for layer in (1, GCNII_LAYERS):
        checks[layer] = _epilogue_check(st, se, g, w, seeds, theta_of(0.5, layer), rate)
    checks["p=0.5"] = _epilogue_check(st, se, g, w, seeds, theta_of(0.5, 1), 0.5)
    _epilogue_graph_masks()
    theta = theta_of(0.5, 1)
    _, _, keep, relu = kernels.gcnii_epilogue(st, se, w, seeds, theta, rate, True)
    stg, wg = st.clone().requires_grad_(True), w.clone().requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def aten_forward():
        zt = torch.addmm(stg, stg, wg, beta=1.0 - theta, alpha=theta)
        hd = dropout(torch.relu(zt), rate, gen, True)
        with torch.no_grad():
            he = torch.relu(torch.addmm(se, se, w, beta=1.0 - theta, alpha=theta))
        return torch.cat([hd, he], dim=1), hd

    def aten_both():
        _, hd = aten_forward()
        torch.autograd.grad(hd, (stg, wg), g)

    def fused_both():
        ht, _ = gcnii_epilogue(stg, se, wg, theta, rate, gen, True)
        torch.autograd.grad(ht, (stg, wg), g)

    fns = {"forward": lambda: kernels.gcnii_epilogue(st, se, w, seeds, theta, rate, True),
           "backward": lambda: kernels.gcnii_epilogue_bwd(g, keep, relu, w, theta, rate),
           "op_both": fused_both, "aten_forward": aten_forward, "aten_both": aten_both}
    ms = {k: cuda_ms(fn, EPILOGUE_ITERS) for k, fn in fns.items()}
    device = {k: _device_us(fns[k]) for k in ("forward", "backward")}
    item = 4
    work = {"forward": (n * h * (4 * item + 1) + n * h // 8, 2 * 2 * n * h * h),
            "backward": (n * h * (3 * item + 1) + n * h // 8, 2 * n * h * h)}
    rows = {}
    for k, (nbytes, flops) in work.items():
        bound, by = _bound(nbytes, flops)
        rows[k] = dict(ms=ms[k], device_us=device[k], bound_ms=bound, bound_by=by, bytes=nbytes,
                       flops=flops)
        log(f"  {k}: {ms[k]:.4f} ms (device {device[k] / 1e3:.4f} ms), bound {bound:.4f} ms "
            f"({by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP): {100 * bound / ms[k]:.1f}% "
            f"of it")
    log(f"  ATen's chain it replaced: forward {ms['aten_forward']:.4f} ms (addmm, ReLU, dropout "
        f"of each half's training half, the concatenation), forward with backward "
        f"{ms['aten_both']:.4f} ms; the op (kernels, seeds, dW by cuBLAS) forward with backward "
        f"{ms['op_both']:.4f} ms")
    log(f"  {_clocks()}")
    return dict(rows=rows, library_ms=ms["aten_forward"], library_both_ms=ms["aten_both"],
                op_both_ms=ms["op_both"], checks=checks)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--nccl-graphs"]:
        phase_build()
        phase_nccl_graphs()
        log(f"(s) passed on {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
        phase_bench_scaling()
        log(f"(u) passed on {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
        return 0
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
    host = phase_native(dataset)
    graph, errs = phase_kernels(dataset, device)
    phase_tile_cases(errs)
    phase_third_part()
    phase_deep_rows(errs)
    launches = phase_main_path(dataset)
    dense_ms = phase_steady(graph, dataset)
    kernels_line = phase_timing(graph, launches, errs)
    phase_profile(graph, dataset)
    phase_epoch_events(graph, dataset)
    layer0 = phase_sparse_kernels(dataset)
    sparse_ms = phase_steady(graph, dataset, " with sparse layer-0 features", sparse=True)
    log(f"  steady fused loop, same graph and call: dense features {dense_ms:.2f} ms/epoch, "
        f"sparse features {sparse_ms:.2f} ms/epoch")
    del graph
    torch.cuda.empty_cache()
    sparse_launches = phase_sparse_path(dataset)
    phase_small_reference()
    bf16 = phase_bf16(dataset, errs)
    graphs_out = phase_graphs(dataset)
    del dataset
    torch.cuda.empty_cache()
    bench_run = phase_bench()
    errs["ell_spmm"] = 0.0
    pallas_launches, pubmed_timing = phase_pallas_path(errs)
    reddit, ell_split = phase_ell_reddit(errs)
    probe_rows = phase_probes(errs)
    taa_rows = phase_taa_probes(errs)
    layer0_pair = phase_layer0_pair()
    gat = phase_gat()
    gcnii = phase_gcnii()
    epilogue = phase_gcnii_epilogue()
    text_launches = phase_text_entry()
    cli_timers = phase_cli_extras()
    shard = phase_sharded()
    errs4x = {"bsr_tile": 0.0, "csr_spmm": 0.0}
    reddit4x = phase_reddit4x(errs4x)
    for line in kernels_line:  # kernels 1 and 2: the launches of the sparse-feature run too
        line["launches_sparse_run"] = sparse_launches[line["name"]]
        if line["name"] == "csr_spmm":
            line["layer0_forward"] = layer0["forward"]
            line["launches_text_run"] = text_launches["csr_spmm"]
    d = WIDTHS[-1]
    graphs = {"synth-pubmed": pubmed_timing,
              "synth-reddit": reddit["as loaded"]["timing"],
              "synth-reddit relabelled": reddit["relabelled"]["timing"]}

    def by_width(key):
        return {g: {str(w): r[key] for w, r in t.items()} for g, t in graphs.items()}

    row = graphs["synth-reddit"][d]
    kernels_line.append({
        "name": "ell_spmm", "route": "cuda", "source": "cuda_gcn_torch/csrc/ell_spmm.cu",
        "replaces": "cuda_gcn_tpu/ops/pallas_spmm.py:67 (_ell_kernel)",
        "launches": pallas_launches["ell_spmm"], "max_abs_err": errs["ell_spmm"],
        "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "d": d, "graph": "synth-reddit",
        "host_us_per_call": ell_split["host_us"], "device_us": ell_split["device_us"],
        "ms_by_width": by_width("ms"), "plain_ms_by_width": by_width("plain_ms"),
        "bound_ms_by_width": by_width("bound_ms"),
        "library_ms_by_width": by_width("library_ms"),
        "gather_no_reuse_ms_by_width": by_width("gather_no_reuse_ms"),
        "gather_tb_per_s_by_width": by_width("gather_tb_per_s"),
        "item_order": {g: reddit[g]["order"] for g in reddit},
        "ms_by_item_order": {g: reddit[g]["orders"] for g in reddit},
        "ell_epoch_ms": {g: reddit[g]["epoch_ms"] for g in reddit},
        "layer0_dw": layer0["dw"], "launches_sparse_run": sparse_launches["ell_spmm"],
        "launches_text_run": text_launches["ell_spmm"]})
    for name, line in probe_rows.items():
        kernels_line.append({
            "name": name, "route": "cuda", "source": "cuda_gcn_torch/csrc/gather_probe.cu",
            "replaces": "scripts/exp_pallas_gather.py:" + (
                "60 (gather_kernel)" if name == "gather_probe" else "85 (scatter_kernel)"),
            "max_abs_err": errs[name], **line})
    replaces = {
        "taa_rows": "scripts/exp_pallas_taa.py:77 (taa_kernel); exp_dyngather.py:38 "
                    "(sublane_kernel); exp_dyngather2.py:53,60,71,101 (k1, k2, k3, k5); "
                    "exp_dyngather3.py:27 (try_taa, axis 0)",
        "taa_lanes": "scripts/exp_dyngather.py:54 (lane_kernel); exp_dyngather2.py:92 (k4); "
                     "exp_dyngather3.py:27 (try_taa, axis 1)",
        "cumsum_cols": "scripts/exp_pallas_taa.py:98 (cumsum_kernel)",
        "piece": "scripts/exp_pallas_taa.py:117 (piece_kernel)"}
    for name, line in taa_rows.items():
        kernels_line.append({"name": name, "route": "cuda",
                             "source": "cuda_gcn_torch/csrc/taa_probe.cu",
                             "replaces": replaces[name], **line})
    reddit_f32 = layer0_pair["rows"]["synth-reddit float32"]
    kernels_line.append({
        "name": "layer0_pair", "route": "cuda", "source": "cuda_gcn_torch/csrc/layer0_pair.cu",
        "replaces": "none: XLA fuses the dropout into the layer-0 product "
                    "(cuda_gcn_tpu/models/gcn.py:32-48)",
        "launches": launches["layer0_pair"], "launches_smoke": layer0_pair["launches"],
        "ms": reddit_f32["ms"], "plain_ms": reddit_f32["plain_ms"],
        "bound_ms": reddit_f32["bound_ms"], "bound_by": reddit_f32["bound_by"],
        "library_ms": reddit_f32["library_ms"], "device_us": reddit_f32["device_us"],
        "device_by": reddit_f32["device_by"], "shapes": layer0_pair["rows"]})
    kernels_line += _bf16_kernel_lines(bf16)
    for name in GAT_KERNELS:  # (w): the GAT's attention kernels at both layers' shapes
        rows = {k: v for k, v in gat["rows"].items() if k.split()[0] == name}
        kernels_line.append({
            "name": name, "route": "cuda", "source": "cuda_gcn_torch/csrc/gat_attention.cu",
            "replaces": "none in the JAX package (it has no attention model)",
            "launches": gat["launches"][name], "ms": rows, "device_us": gat["device"][name],
            "worst_err_of_tol": gat["worst"]})
    kernels_line.append({  # (x): kernel 3's blended form
        "name": "ell_blend", "route": "cuda", "source": "cuda_gcn_torch/csrc/ell_spmm.cu",
        "replaces": "none in the JAX package (it has no GCNII)",
        "launches": gcnii["launches"]["ell_blend"], "ms": gcnii["rows"],
        "kernel3_ms": gcnii["spmm_ms"], "graph_agree": gcnii["agree"],
        "epoch_ms": gcnii["epoch_ms"], "peak_gib": gcnii["peak_gib"]})
    kernels_line.append({  # (y): GCNII's convolution epilogue, both kernels
        "name": "gcnii_epilogue", "route": "cuda", "source": "cuda_gcn_torch/csrc/gcnii_epilogue.cu",
        "replaces": "none in the JAX package (it has no GCNII)",
        "launches": {k: gcnii["launches"][k] for k in ("gcnii_epilogue", "gcnii_epilogue_bwd")},
        "ms": epilogue["rows"], "library_ms": epilogue["library_ms"],
        "library_both_ms": epilogue["library_both_ms"], "op_both_ms": epilogue["op_both_ms"],
        "checks": epilogue["checks"]})
    for line in kernels_line:  # (t): the benchmark entry's measured run
        if line["name"] in bench_run["launches"]:
            line["launches_bench"] = bench_run["launches"][line["name"]]
    for line in kernels_line:  # (r): the graphed 100-epoch loops
        cell = {"bsr_tile": "synth-reddit bsr", "csr_spmm": "synth-reddit bsr",
                "ell_spmm": "synth-pubmed pallas"}.get(line["name"])
        if cell:
            r = graphs_out[cell]
            line["graph"] = dict(cell=cell, launches=r["launches"][line["name"]],
                                 agree=r["agree"], run_ms=r["run_ms"],
                                 steady_ms={k: v["ms"] for k, v in r["steady"].items()})
    for line in kernels_line:  # kernels 1-3 at synth-reddit4x: checked, timed, bounded
        name = line["name"]
        if name in reddit4x["kernels"]:
            at4x = {k: v for k, v in reddit4x["kernels"][name].items()
                    if k not in ("name", "route", "source", "replaces", "launches")}
            line["synth_reddit4x"] = dict(at4x, max_abs_err=errs4x[name])
        elif name == "ell_spmm":
            line["synth_reddit4x"] = {"layer0_dw": reddit4x["layer0"]["dw"]}
        if name == "csr_spmm":
            line["synth_reddit4x"]["layer0_forward"] = reddit4x["layer0"]["forward"]
        if name in shard["errs"]:  # kernels 1 and 2 in the sharded trainer (p)
            rk = shard["rank_kernels"]
            t = rk["timing"]
            line["sharded"] = dict(
                max_abs_err=shard["errs"][name],
                launches_per_rank={f"P={w}": info["runs"]["float32"]["launches"][name]
                                   for w, info in shard["worlds"].items()},
                rank0_of_P2={k: v for k, v in rk.items() if k != "timing"},
                by_width=(t["bsr_tile"] if name == "bsr_tile" else
                          {"interior": t["csr_spmm interior"],
                           "boundary": t["csr_spmm boundary"]}))
    log(f"steady fused epoch on synth-reddit in this call: bsr {dense_ms:.2f} ms (sparse "
        f"features {sparse_ms:.2f}), ell {reddit['as loaded']['epoch_ms']:.2f} ms as loaded and "
        f"{reddit['relabelled']['epoch_ms']:.2f} ms relabelled; at compute bf16: bsr "
        f"{bf16['epoch_ms']['bsr']:.2f} ms (param bf16 too: {bf16['epoch_ms']['bsr, param bf16']:.2f}), "
        f"ell {bf16['epoch_ms']['ell']:.2f} ms as loaded")
    log(f"synth-reddit4x: {reddit4x['nodes']} nodes, {reddit4x['edges']} edges, K="
        f"{reddit4x['tiles']} tiles, {reddit4x['residual_edges']} residual edges; steady "
        f"fused epoch dense {reddit4x['epoch_ms']['dense']:.2f} ms (busy share "
        f"{reddit4x['busy_share']:.3f}), sparse {reddit4x['epoch_ms']['sparse']:.2f} ms, "
        f"backend segment {reddit4x['epoch_ms']['segment dense']:.2f} ms; peak "
        f"device memory {reddit4x['peak_device_gb']['dense']:.2f} / "
        f"{reddit4x['peak_device_gb']['sparse']:.2f} GB of {reddit4x['device_gb']:.1f}; host "
        f"set-up s {json.dumps({k: round(v, 1) for k, v in reddit4x['host_setup_s'].items()})}"
        f", host peak {reddit4x['host_peak_gb']:.1f} GB")
    log(f"sharded synth-reddit (p): single device {shard['single_epoch_ms']:.2f} ms/fused "
        "epoch; " + "; ".join(
        f"P={w} {info['backend']}: ms/fused epoch per rank "
        + ", ".join(f"{h} {[round(v, 2) for v in r['epoch_ms']]}" for h, r in info["runs"].items())
        + f", boundary edge fraction {info['boundary_fraction']:.4f}"
        for w, info in shard["worlds"].items()) + " (ranks of P=2 and 4 share one card)")
    log(f"native host code (q), {host['cores']}: g++ {host['build_s']:.2f} s; synth-reddit LPA "
        f"native {host['lpa_native_s']:.2f} s against numpy {host['lpa_numpy_s']:.2f} s, bsr "
        f"build native {host['graph_build']['native']['seconds']:.2f} s against numpy "
        f"{host['graph_build']['numpy']['seconds']:.2f} s; synth-pubmed parse native "
        f"{host['parse_s']['native']:.2f} s against numpy {host['parse_s']['numpy']:.2f} s; "
        f"synth-reddit4x LPA native {reddit4x['host_setup_s']['lpa_s']:.2f} s against numpy "
        f"{reddit4x['lpa_numpy_s']:.2f} s, build steps s "
        + json.dumps({w: {k: round(v, 2) for k, v in b.items()}
                      for w, b in reddit4x["build_steps_s"].items()}))
    log("epoch graphs (r): " + "; ".join(
        f"{cell} steady ms/epoch eager {r['steady']['eager']['ms']:.3f} (busy share "
        f"{r['steady']['eager']['busy_share']:.3f}) graph {r['steady']['graph']['ms']:.3f} "
        f"(busy share {r['steady']['graph']['busy_share']:.3f}), host "
        f"{r['replay_host_us_median']:.1f} us per replay"
        for cell, r in graphs_out.items() if "steady" in r)
        + f"; early stopping ms/epoch {graphs_out['early stopping']['ms']}, flag read "
        f"{graphs_out['early stopping']['flag_read_us']:.1f} us")
    log(f"benchmark entry (t): {bench_run['doc']['value']} s for {BENCH_EPOCHS} epochs, "
        f"sol_fraction_lower_bound {bench_run['doc']['detail']['sol_fraction_lower_bound']}, "
        f"compile_s {bench_run['doc']['detail']['compile_s']}, "
        f"{bench_run['wall_s']:.1f} s of command")
    log("--timing phases on synth-pubmed (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in cli_timers.items()))
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
