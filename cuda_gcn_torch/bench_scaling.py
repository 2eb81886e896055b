"""Scaling bench of the sharded trainer: edge-passes/s at 1..P ranks, one card a rank.

    python -m cuda_gcn_torch.bench_scaling [--dataset pubmed] [--parts 1,2,4,8]
        [--epochs 20] [--interior auto|segment] [--out PATH] [--stats-only]
        [--device cuda|cpu]

The counterpart of the JAX package's ``scripts/bench_scaling.py``. The
dataset is the benchmark entry's (bench.py ``load_bench_dataset``); its LPA
labels are computed once and cached at ``CACHE_DIR/<name>.lpa.<key>.npy``
(``reorder.lpa_cache_key``: the graph's contents and the LPA version). For
each P the dataset is relabelled by ``reorder.partition_layout`` and cut by
``partition_graph`` at the layout's cuts, and the partition's statistics are
reported as the JAX script reports them (``partition_stats``). With
``--stats-only`` nothing else runs, and any P can be computed.

Otherwise P ranks are started by ``parallel/multihost.run_ranks``: on the card
one NCCL rank a card (a P above the card count is skipped, as the JAX script
skips one above its device count), with ``--device cpu`` P gloo ranks on the
host. ``prepare_sharded`` lays the dataset out from the same labels, so the
statistics describe the layout that trains. Each rank runs one warm-up call
of ``sharded.run_epochs_chunked`` (builds, NCCL's communicators, the capture)
and then a timed call from a fresh state; ``seconds`` is the slowest rank's,
and ``edges_per_s`` counts the executed adjacency passes, nnz · (4 · epochs +
2) / seconds. ``scaling_efficiency`` is against P = 1. On stderr each rank's
kernel launches in the timed call, and its steady ms an epoch with the capture
left out: epochs of the same pass-fused epoch after the timed call, replays of
a CUDA graph of it on the card (eager under gloo).

One JSON payload on stdout, and in ``--out`` when given. Where the ranks share
a host's CPU, it carries a ``caveat`` saying that its times are the
harness's; a timed payload names its device (``device``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from cuda_gcn_torch import bench


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def partition_stats(pg, nnz: int) -> tuple[float, dict]:
    """(boundary fraction, statistics) of a PartitionedGraph, as the JAX
    script computes them from its full local COO: a part's real edges are its
    interior residual, tile-covered and boundary edges with a coefficient
    above 0; the halo rows in use are the distinct halo columns of the real
    boundary edges; the padded rows are the send sections' slots."""
    real_edges = (pg.i_coef > 0).sum(axis=1) + (pg.b_coef > 0).sum(axis=1)
    if pg.tb:
        real_edges = real_edges + np.array([(v > 0).sum() for v in pg.i_tile_vals])
    bnd_edges = (pg.b_coef > 0).sum(axis=1)
    boundary_frac = float(bnd_edges.sum() / max(nnz, 1))
    actual_rows = sum(len(np.unique(pg.b_dst[q][pg.b_coef[q] > 0]))
                      for q in range(pg.n_parts))
    padded_rows = sum(int(sec.size) for sec in pg.send_secs)
    stats = dict(
        block=pg.block,
        halo_space=pg.halo_space,
        hmax_k=[int(h) for h in pg.hmax_k],
        send_rows_padded=padded_rows,
        send_pad_overhead=round(padded_rows / max(actual_rows, 1), 3),
        edge_balance=round(float(real_edges.max() / max(real_edges.mean(), 1)), 3),
        per_part_boundary_frac=[round(float(b / max(t, 1)), 4)
                                for b, t in zip(bnd_edges, real_edges)],
    )
    return boundary_frac, stats


def _steady_ms(state, inputs, truths, cfg, device, epochs: int) -> float:
    """ms an epoch of ``epochs`` pass-fused epochs, the capture left out: an
    eager epoch, the capture and its first replay, then the timed replays
    (eager epochs under gloo, which a capture cannot hold)."""
    from cuda_gcn_torch import kernels, train
    from cuda_gcn_torch.parallel import sharded

    run = train._epoch_runner(
        lambda: sharded._fused_epoch(state, inputs, truths[1], truths[2], cfg), state,
        sharded._graphed(device), (kernels.launches, inputs.exchange.sent))
    run()
    run()
    sharded._sync(device)
    t0 = time.perf_counter()
    for _ in range(epochs):
        run()
    sharded._sync(device)
    return (time.perf_counter() - t0) * 1e3 / epochs


def _rank(rank: int, world: int, init_method: str, cfg, device_type: str, epochs: int,
          shard) -> dict:
    """One rank: a warm-up call and a timed call of ``run_epochs_chunked``,
    each from a fresh state and after an all-reduce that lines the ranks up;
    then the steady epoch. Returns the timed call's seconds and launches."""
    import torch

    from cuda_gcn_torch import kernels
    from cuda_gcn_torch.parallel import multihost, sharded

    device = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    multihost.initialize(init_method, world, rank, device=device)
    inputs, truths = sharded.shard_inputs(cfg, shard, device)

    def timed_call():
        state = sharded.create_state(cfg, device, rank)
        sharded._all_reduce(torch.zeros(1, device=device)).cpu()
        t0 = time.perf_counter()
        sharded.run_epochs_chunked(state, inputs, truths[1], truths[2], cfg, epochs).cpu()
        return state, time.perf_counter() - t0

    timed_call()
    kernels.reset_launches()
    state, seconds = timed_call()
    launches = {k: v for k, v in kernels.launches.items() if v}
    return dict(seconds=seconds, launches=launches,
                steady_ms=_steady_ms(state, inputs, truths, cfg, device, epochs))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m cuda_gcn_torch.bench_scaling")
    ap.add_argument("--dataset", default="pubmed")
    ap.add_argument("--parts", default="1,2,4,8")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--interior", default="auto", choices=["auto", "segment"],
                    help="interior aggregation: auto (tiles on bsr above "
                         "DENSE_BACKEND_MAX_NODES nodes a part) or segment (kernel 2 only)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the JSON payload to PATH")
    ap.add_argument("--stats-only", action="store_true",
                    help="partition statistics only, no training")
    ap.add_argument("--device", default="cuda", help="torch device (cpu: gloo ranks)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    from cuda_gcn_torch.config import GCNConfig
    from cuda_gcn_torch.data.reorder import (label_propagation, lpa_cache_key,
                                             partition_layout, reorder_dataset)
    from cuda_gcn_torch.device import resolve_device
    from cuda_gcn_torch.parallel import multihost, sharded
    from cuda_gcn_torch.parallel.partition import partition_graph

    device = resolve_device(args.device)
    ds0, name = bench.load_bench_dataset(args.dataset, "data")
    key = lpa_cache_key(ds0.graph.indptr, ds0.graph.indices)
    lpa_cache = os.path.join(bench.CACHE_DIR, f"{name}.lpa.{key}.npy")
    if os.path.exists(lpa_cache):
        labels = np.load(lpa_cache)
        log(f"loaded cached LPA labels for {name} ({key})")
    else:
        labels = label_propagation(ds0.graph.indptr, ds0.graph.indices)
        os.makedirs(bench.CACHE_DIR, exist_ok=True)
        np.save(lpa_cache, labels)
    degrees = np.diff(ds0.graph.indptr.astype(np.int64))
    nnz = ds0.graph.nnz
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    platform = "gpu" if device.type == "cuda" else device.type
    log(f"{name}: n={ds0.num_nodes} nnz={nnz} cards={cards} platform={platform}")

    results = []
    for p in (int(s) for s in args.parts.split(",")):
        if not args.stats_only and device.type == "cuda" and p > cards:
            log(f"skip P={p}: only {cards} cards")
            continue
        perm, cuts = partition_layout(ds0.graph.indptr, ds0.graph.indices, labels, p,
                                      weights=degrees)
        pg = partition_graph(reorder_dataset(ds0, perm).graph, p, cuts=cuts)
        boundary_frac, stats = partition_stats(pg, nnz)
        if args.stats_only:
            results.append(dict(parts=p, boundary_fraction=round(boundary_frac, 4),
                                partition=stats))
            log(f"P={p}: boundary={boundary_frac * 100:.1f}%  "
                f"pad_overhead={stats['send_pad_overhead']}x  balance={stats['edge_balance']}")
            continue
        cfg = GCNConfig(epochs=args.epochs, seed=0,
                        graphsum_backend="segment" if args.interior == "segment" else "auto")
        cfg, shards, _ = sharded.prepare_sharded(cfg, ds0, p, lpa_labels=labels, device=device)
        ranks = multihost.run_ranks(_rank, p, (cfg, device.type, args.epochs),
                                    rank_args=[(s,) for s in shards], timeout=1800)
        dt = max(r["seconds"] for r in ranks)
        eps = nnz * (4 * args.epochs + 2) / dt
        results.append(dict(parts=p, seconds=round(dt, 4), edges_per_s=round(eps),
                            boundary_fraction=round(boundary_frac, 4), partition=stats))
        log(f"P={p}: {dt:.3f}s  {eps:,.0f} edge-passes/s  boundary={boundary_frac * 100:.1f}%  "
            f"pad_overhead={stats['send_pad_overhead']}x  balance={stats['edge_balance']}")
        for rank, r in enumerate(ranks):
            log(f"  P={p} rank {rank}: timed call {r['seconds']:.4f}s, steady "
                f"{r['steady_ms']:.3f} ms/epoch (capture left out), launches "
                f"{json.dumps(r['launches'])}")

    if results and "edges_per_s" in results[0]:
        base = results[0]["edges_per_s"] / results[0]["parts"]
        for r in results:
            r["scaling_efficiency"] = round(r["edges_per_s"] / (base * r["parts"]), 3)
    payload = {"dataset": name, "epochs": args.epochs, "platform": platform,
               "n_nodes": ds0.num_nodes, "nnz": nnz, "results": results}
    if any("seconds" in r for r in results):
        ran = max(r["parts"] for r in results if "seconds" in r)
        payload["device"] = ("; ".join(bench.device_label(f"cuda:{i}") for i in range(ran))
                             if device.type == "cuda" else bench.device_label(device))
        if device.type != "cuda":
            payload["caveat"] = (
                "CPU RANKS: every rank is a gloo process on one host's CPU running the "
                "plain PyTorch versions, so 'seconds', 'edges_per_s' and "
                "'scaling_efficiency' measure the harness, NOT card scaling. Only the "
                "partition stats (boundary_fraction, send_pad_overhead, edge_balance, "
                "hmax_k) are hardware-independent.")
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
