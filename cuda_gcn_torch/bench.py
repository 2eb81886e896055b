"""Benchmark entry of the port: 100 full-batch epochs at reddit scale on one card.

    python -m cuda_gcn_torch.bench [--dataset reddit] [--epochs 100]
        [--backend auto|segment|ell|pallas|dense|bsr] [--compute-dtype float32|bfloat16]
        [--feature-matmul dense|sparse] [--bsr-budget-gb GB] [--data-dir data]
        [--compilation-cache DIR] [--device cuda|cpu]

The counterpart of the JAX package's ``bench.py`` (:156-273), in its order:
the dataset (``data/<name>.graph`` when present, else the cached or generated
synthetic profile), ``auto`` → ``dense`` at ``DENSE_BACKEND_MAX_NODES`` nodes
and fewer, else ``bsr`` with the cached locality permutation; ``train.prepare``
at seed 0; one whole warm-up run through ``train.run_epochs_chunked`` (kernel
builds, the epoch's capture and 100 epochs; ``compile_s``); the measured run
from a fresh ``train.create_state``, also through ``run_epochs_chunked`` (a CUDA
graph of the epoch on the card, captured after its eager epoch 1); then the
test eval. Headline: the measured run's seconds. ``vs_baseline`` is the
reference's CUDA time on a Tesla M60 (report.pdf §3.3) over it.

ONE JSON line on stdout, the JAX entry's contract (:112-147): ``metric``,
``value`` (s), ``unit``, ``vs_baseline`` and ``detail`` with the JAX keys
less ``tile_engine`` (a TPU setting). ``sol_fraction_lower_bound`` bills the
whole epoch to the adjacency passes at pass width 2·max(hidden, output), as
the JAX entry does, against ``utils/profiling.spmm_speed_of_light``'s H100
model. ``device`` is the card's name and power limit (``nvidia-smi``) or
``cpu``. A failure prints the same line with ``value`` null and the error in
``detail.error``, and exits 0: the port has one route per backend, so there
is no second attempt. Everything else goes to stderr, with one line the JAX
entry does not print: the measured run's steady ms an epoch, its chunks after
the first (the first holds the eager epoch and the capture).

``--compilation-cache`` is the CLI's: the directory the kernel and host
libraries are built into and loaded from (default ``build/``, where a
library already built is not built again; ``''`` a temporary directory). It
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from cuda_gcn_torch.data import dataset as dataset_mod

# gcn-cuda total train time per dataset on a Tesla M60 (report.pdf §3.3 "Raw results")
BASELINE_CUDA_S = {
    "cora": 0.20823, "citeseer": 0.21186, "pubmed": 1.10340, "reddit": 106.23713,
}
CACHE_DIR = dataset_mod.CACHE_DIR


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or 'cpu'."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def load_bench_dataset(name: str, data_dir: str):
    """(dataset, name) as bench.py:39-72 loads them: ``<data_dir>/<name>.graph``
    and its files, else ``CACHE_DIR/synth-<name>.npz``, else the profile
    generated at seed 0 and written there."""
    from cuda_gcn_torch.data.parser import load_dataset
    from cuda_gcn_torch.data.synthetic import PROFILES, VARIANTS, make_synthetic

    real_name = name.removeprefix("synth-")
    if os.path.exists(os.path.join(data_dir, f"{real_name}.graph")):
        log(f"using real dataset {real_name} from {data_dir}/")
        return load_dataset(real_name, data_dir=data_dir), real_name
    synth = f"synth-{real_name}"
    if synth not in PROFILES and synth not in VARIANTS:
        raise SystemExit(f"no such dataset or profile: {name}")
    cache = os.path.join(CACHE_DIR, f"{synth}.npz")
    if os.path.exists(cache):
        log(f"loading cached {synth}")
        return dataset_mod.load_cached(synth, CACHE_DIR), synth
    log(f"generating {synth} (deterministic, seed 0)...")
    t0 = time.perf_counter()
    ds = make_synthetic(synth, seed=0)
    log(f"generated in {time.perf_counter() - t0:.1f}s "
        f"({ds.num_nodes} nodes, {ds.graph.nnz} nnz incl self-loops)")
    os.makedirs(CACHE_DIR, exist_ok=True)
    np.savez(cache, g_indptr=ds.graph.indptr, g_indices=ds.graph.indices,
             f_indptr=ds.feature_index.indptr, f_indices=ds.feature_index.indices,
             f_values=ds.feature_value, label=ds.label, split=ds.split,
             num_nodes=ds.num_nodes, input_dim=ds.input_dim, output_dim=ds.output_dim)
    return ds, synth


def maybe_reorder_cached(dataset, name: str):
    """The LPA locality relabelling from ``CACHE_DIR/<name>.perm.npy``,
    computed and written there when absent (bench.py:75-91): set-up, not part
    of the timed run."""
    from cuda_gcn_torch.data.reorder import locality_permutation, reorder_dataset

    cache = os.path.join(CACHE_DIR, f"{name}.perm.npy")
    if os.path.exists(cache):
        perm = np.load(cache)
        log(f"loaded cached locality permutation for {name}")
    else:
        t0 = time.perf_counter()
        perm = locality_permutation(dataset.graph)
        os.makedirs(CACHE_DIR, exist_ok=True)
        np.save(cache, perm)
        log(f"computed locality permutation in {time.perf_counter() - t0:.1f}s")
    return reorder_dataset(dataset, perm)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cuda_gcn_torch.bench")
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--backend", default="auto",
                    choices=["segment", "ell", "pallas", "dense", "bsr", "auto"])
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--feature-matmul", default="dense", choices=["dense", "sparse"],
                    help="layer-0 input matmul: densified X, or its CSR values "
                         "(the reference program's)")
    ap.add_argument("--bsr-budget-gb", type=float, default=None,
                    help="pin the BSR tile budget (GiB); default: from the card's free memory")
    ap.add_argument("--data-dir", default="data")
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="directory the kernel and host libraries are built into and "
                         "loaded from (default: build/ at the repository root; '' a "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the plain versions)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    try:
        result = run_bench(args)
    except Exception as e:
        import traceback

        log(traceback.format_exc())
        result = _error_result(args, f"{type(e).__name__}: {e}"[:400])
    print(json.dumps(result))
    return 0


def _error_result(args, err: str) -> dict:
    return {"metric": f"{args.dataset}_{args.epochs}ep_train_time",
            "value": None, "unit": "s", "vs_baseline": None,
            "detail": {"error": err}}


def steady_ms(times: list[float]) -> tuple[float | None, int]:
    """(ms an epoch, epochs) over the chunks after the first of a chunked
    run's per-epoch times (each chunk's time spread evenly over its epochs,
    so a chunk ends where the value changes); (None, 0) for one chunk."""
    first = next((i for i, t in enumerate(times) if t != times[0]), len(times))
    rest = times[first:]
    return (sum(rest) / len(rest) * 1e3 if rest else None), len(rest)


def run_bench(args) -> dict:
    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.graph import DENSE_BACKEND_MAX_NODES
    from cuda_gcn_torch.device import resolve_device
    from cuda_gcn_torch.utils.profiling import (DEFAULT_HBM_GBPS, GATHER_TRANSACTION_BYTES,
                                                spmm_speed_of_light)

    if args.compilation_cache is not None:
        from cuda_gcn_torch.utils.compile_cache import use_build_dir

        use_build_dir(args.compilation_cache)
    device = resolve_device(args.device)
    card = device_label(device)
    dataset, name = load_bench_dataset(args.dataset, args.data_dir)
    backend = args.backend
    if backend == "auto":
        backend = "dense" if dataset.num_nodes <= DENSE_BACKEND_MAX_NODES else "bsr"
    if backend == "bsr":
        dataset = maybe_reorder_cached(dataset, name)
    cfg = GCNConfig(epochs=args.epochs, graphsum_backend=backend, reorder="none",
                    compute_dtype=args.compute_dtype, seed=0,
                    feature_matmul=args.feature_matmul, bsr_budget_gb=args.bsr_budget_gb)
    cfg, graph, x, truths = train.prepare(cfg, dataset, device)
    log(f"device: {card}; backend={graph.backend}; nnz={graph.total_nnz} "
        f"(residual {graph.resid_nnz}, {graph.num_tiles} tiles); dims={cfg.layer_dims()}")

    # warm-up: kernel libraries loaded, the epoch captured, the whole run once
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    state = train.create_state(cfg, device)
    train._sync(device)
    t0 = time.perf_counter()
    train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=args.epochs,
                             **kw).cpu()
    compile_s = time.perf_counter() - t0
    log(f"warmup (builds + capture + full run): {compile_s:.2f}s")

    # measured run: fresh state, the reference's per-epoch work (train step +
    # validation eval), a CUDA graph of the pass-fused epoch on the card
    state = train.create_state(cfg, device)
    times: list[float] = []
    kernels.reset_launches()
    train._sync(device)
    t0 = time.perf_counter()
    metrics = train.run_epochs_chunked(state, graph, x, truths[1], truths[2],
                                       epochs=args.epochs, times_out=times, **kw).cpu()
    train_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launches.items() if v}
    tl, ta, vl, va = (float(v) for v in metrics[-1])

    test_loss, test_acc = train.eval_step(state.model, graph, x, truths[3],
                                          weight_decay=cfg.weight_decay)
    log(f"epoch={args.epochs} train_loss={tl:.5f} train_acc={ta:.5f} "
        f"val_loss={vl:.5f} val_acc={va:.5f}")
    log(f"test_loss={float(test_loss):.5f} test_acc={float(test_acc):.5f}")
    log(f"total training time={train_s:.5f} ({train_s / args.epochs * 1000:.2f} ms/epoch)")
    steady, n_steady = steady_ms(times)
    log("steady: " + (f"{steady:.3f} ms/epoch over the chunks after the first "
                      f"({n_steady} epochs)" if steady is not None
                      else "one chunk, no epoch without the capture")
        + f"; kernel launches in the measured run: {json.dumps(launches)}")

    # edge-passes/s two ways: the reference's 6 adjacency passes an epoch (2
    # layers x fwd+bwd in train, 2 fwd in eval) and the fused loop's 4, +2 for
    # the trailing eval
    ref_passes = 6 * args.epochs
    exec_passes = 4 * args.epochs + 2
    total_nnz = dataset.graph.nnz
    edges_per_s = total_nnz * ref_passes / train_s
    exec_edges_per_s = total_nnz * exec_passes / train_s
    log(f"graphsum edge-passes/s: {edges_per_s:,.0f} (reference-equivalent, 6/epoch); "
        f"{exec_edges_per_s:,.0f} physically executed ({exec_passes} passes)")

    # roofline lower bound: the whole epoch billed to the adjacency passes
    per_pass_s = train_s / exec_passes
    tile_bytes = 0 if graph.tiles is None else graph.tiles.numel() * graph.tiles.element_size()
    pass_width = 2 * max(cfg.hidden_dim, cfg.output_dim)  # fused pair widths
    sol = spmm_speed_of_light(
        total_nnz, pass_width, per_pass_s, dense_tile_bytes=tile_bytes,
        residual_nnz=graph.resid_nnz if graph.backend == "bsr" else None)
    log(f"speed-of-light: ideal {sol['ideal_s'] * 1000:.3f} ms/pass, measured "
        f"<= {per_pass_s * 1000:.3f} ms/pass -> sol_fraction >= {sol['sol_fraction']:.3f}")

    base = BASELINE_CUDA_S.get(name.removeprefix("synth-"))
    vs = base / train_s if base else float("nan")
    return {
        "metric": f"{name}_{args.epochs}ep_train_time",
        "value": round(train_s, 5),
        "unit": "s",
        "vs_baseline": round(vs, 3) if np.isfinite(vs) else None,
        "detail": {
            "backend": graph.backend,
            "feature_matmul": cfg.feature_matmul,
            "compile_s": round(compile_s, 2),
            "ms_per_epoch": round(train_s / args.epochs * 1000, 3),
            "spmm_edge_passes_per_s": round(edges_per_s),
            "spmm_edge_passes_per_s_basis": "reference-equivalent (6 passes/epoch)",
            "spmm_executed_passes_per_s_min": round(exec_edges_per_s),
            "executed_passes_min": exec_passes,
            "sol_fraction_lower_bound": round(sol["sol_fraction"], 4),
            "sol_ideal_s_per_pass": round(sol["ideal_s"], 6),
            "sol_basis": ("whole epoch time attributed to spmm passes; gathers billed at "
                          f"max(row bytes, {GATHER_TRANSACTION_BYTES} B) an edge, tiles "
                          f"streamed once, both at {DEFAULT_HBM_GBPS:,.0f} GB/s (H100 SXM "
                          "HBM3; utils/profiling.spmm_speed_of_light)"),
            "test_acc": round(float(test_acc), 5),
            "baseline_cuda_s": base,
            "device": card,
        },
    }


if __name__ == "__main__":
    sys.exit(main())
