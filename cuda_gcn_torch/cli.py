"""Command-line entry point of the port.

    python -m cuda_gcn_torch.cli synth-reddit --epochs 5 [--device cpu]
                                 [--backend auto|bsr|segment|ell|pallas|dense]
                                 [--early-stopping N]

Trains on a cached synthetic profile (``.cache/<name>.npz``) and prints the
output contract of cuda_gcn_tpu.cli. The bsr backend relabels the dataset with
the cached locality permutation ``.cache/<name>.perm.npy`` when there is one,
and computes the permutation (LPA, data/reorder.py) otherwise. It runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from cuda_gcn_torch.config import GCNConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_gcn_torch",
                                description="Full-batch GCN training on an NVIDIA GPU.")
    p.add_argument("graph_name", help="cached synthetic profile, e.g. synth-reddit")
    p.add_argument("--epochs", type=int, default=GCNConfig.epochs)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "segment", "ell", "pallas", "dense", "bsr"])
    p.add_argument("--early-stopping", type=int, default=GCNConfig.early_stopping,
                   metavar="N", help="stop when the val loss exceeds the mean of the "
                                     "last N (0: off)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    from cuda_gcn_torch import train
    from cuda_gcn_torch.data.dataset import (cached_permutation_path, load_cached,
                                             reorder_cached)
    from cuda_gcn_torch.data.graph import DENSE_BACKEND_MAX_NODES
    from cuda_gcn_torch.device import resolve_device

    device = resolve_device(args.device)
    backend = args.backend
    reorder = "auto"
    try:
        dataset = load_cached(args.graph_name)
    except FileNotFoundError as e:
        print(f"Cannot read input: {args.graph_name} ({e})", file=sys.stderr)
        return 1
    if backend == "auto":
        backend = "dense" if dataset.num_nodes <= DENSE_BACKEND_MAX_NODES else "bsr"
    if backend == "bsr" and os.path.exists(cached_permutation_path(args.graph_name)):
        dataset, reorder = reorder_cached(dataset, args.graph_name), "none"
    print(f"Loaded cached dataset {args.graph_name}.")
    print(f"RUNNING ON {device.type.upper()}")
    cfg = GCNConfig(epochs=args.epochs, seed=args.seed, graphsum_backend=backend,
                    reorder=reorder, early_stopping=args.early_stopping)
    train.run(cfg, dataset, device=device, verbose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
