"""Command-line entry point of the port.

    python -m cuda_gcn_torch.cli <name> --epochs 5 [--device cpu] [--data-dir data]
                                 [--backend auto|bsr|segment|ell|pallas|dense]
                                 [--feature-matmul dense|sparse] [--early-stopping N]

A ``synth-*`` name trains on the cached synthetic profile ``.cache/<name>.npz``
(the generator is not ported); any other name is read from
``<data-dir>/<name>.{graph,split,svmlight}`` by data/parser.py, as
cuda_gcn_tpu.cli does (:116-129). The output follows that CLI's contract. The
bsr backend relabels the dataset with the cached locality permutation
``.cache/<name>.perm.npy`` when there is one, and computes the permutation (LPA,
data/reorder.py) otherwise. ``--feature-matmul sparse`` keeps the layer-0
features in CSR, as the reference program does. It runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from cuda_gcn_torch.config import GCNConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_gcn_torch",
                                description="Full-batch GCN training on an NVIDIA GPU.")
    p.add_argument("graph_name", help="dataset name under --data-dir, or a cached "
                                      "synthetic profile, e.g. synth-reddit")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--epochs", type=int, default=GCNConfig.epochs)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "segment", "ell", "pallas", "dense", "bsr"])
    p.add_argument("--feature-matmul", default="dense", choices=["dense", "sparse"],
                   help="layer-0 feature transform: densified X, or the CSR values "
                        "(reference SparseMatmul)")
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
    from cuda_gcn_torch.data.parser import load_dataset
    from cuda_gcn_torch.device import resolve_device

    device = resolve_device(args.device)
    backend = args.backend
    reorder = "auto"
    synthetic = args.graph_name.startswith("synth-")
    try:
        dataset = (load_cached(args.graph_name) if synthetic
                   else load_dataset(args.graph_name, data_dir=args.data_dir))
    except FileNotFoundError as e:
        print(f"Cannot read input: {args.graph_name} ({e})", file=sys.stderr)
        return 1
    if backend == "auto":
        backend = "dense" if dataset.num_nodes <= DENSE_BACKEND_MAX_NODES else "bsr"
    if backend == "bsr" and os.path.exists(cached_permutation_path(args.graph_name)):
        dataset, reorder = reorder_cached(dataset, args.graph_name), "none"
    if synthetic:
        print(f"Loaded cached dataset {args.graph_name}.")
    else:
        print("Parse Graph Succeeded.")
        print("Parse Node Succeeded.")
        print("Parse Split Succeeded.")
    print(f"RUNNING ON {device.type.upper()}")
    cfg = GCNConfig(epochs=args.epochs, seed=args.seed, graphsum_backend=backend,
                    reorder=reorder, early_stopping=args.early_stopping,
                    feature_matmul=args.feature_matmul)
    train.run(cfg, dataset, device=device, verbose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
