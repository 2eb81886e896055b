"""Command-line entry point of the port.

    python -m cuda_gcn_torch.cli <name> --epochs 5 [--device cpu] [--data-dir data]
                                 [--backend auto|bsr|segment|ell|pallas|dense]
                                 [--feature-matmul dense|sparse] [--early-stopping N]
                                 [--seed S] [--compute-dtype float32|bfloat16]

A name of ``data.synthetic.PROFILES`` or ``VARIANTS`` (``synth-cora`` ...
``synth-reddit32x``, ``synth-reddit-slope``) is generated with the run's seed,
``make_synthetic(name, seed=--seed)``, as cuda_gcn_tpu.cli does (:114-118), and
the CLI prints that CLI's line "Generated synthetic dataset <name>.". At seed 0
the generator's output is read from ``.cache/<name>.npz`` when that file exists
(the cache holds ``make_synthetic(name, seed=0)``, bench.py:62-71). Any other
name is read from ``<data-dir>/<name>.{graph,split,svmlight}`` by
data/parser.py (:119-129). The output follows that CLI's contract. The bsr
backend relabels the dataset with the cached locality permutation
``.cache/<name>.perm.npy`` only when the dataset is that cached seed-0 graph,
and computes the permutation (LPA, data/reorder.py) for any other.
``--feature-matmul sparse`` keeps the layer-0 features in CSR, as the reference
program does; ``--compute-dtype bfloat16`` runs the activations in bf16. It runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from cuda_gcn_torch.config import GCNConfig


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_gcn_torch",
                                description="Full-batch GCN training on an NVIDIA GPU.")
    p.add_argument("graph_name", help="dataset name under --data-dir, or a synthetic "
                                      "profile, e.g. synth-reddit")
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
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    from cuda_gcn_torch import train
    from cuda_gcn_torch.data.dataset import (CACHE_DIR, cached_permutation_path,
                                             load_cached, reorder_cached)
    from cuda_gcn_torch.data.graph import DENSE_BACKEND_MAX_NODES
    from cuda_gcn_torch.data.parser import load_dataset
    from cuda_gcn_torch.data.synthetic import PROFILES, VARIANTS, make_synthetic
    from cuda_gcn_torch.device import resolve_device

    device = resolve_device(args.device)
    name = args.graph_name
    backend = args.backend
    reorder = "auto"
    cached = False
    if name in PROFILES or name in VARIANTS:
        cached = args.seed == 0 and os.path.exists(os.path.join(CACHE_DIR, f"{name}.npz"))
        dataset = load_cached(name) if cached else make_synthetic(name, seed=args.seed)
        print(f"Generated synthetic dataset {name}.")
    else:
        try:
            dataset = load_dataset(name, data_dir=args.data_dir)
        except FileNotFoundError as e:
            print(f"Cannot read input: {name} ({e})", file=sys.stderr)
            return 1
        print("Parse Graph Succeeded.")
        print("Parse Node Succeeded.")
        print("Parse Split Succeeded.")
    if backend == "auto":
        backend = "dense" if dataset.num_nodes <= DENSE_BACKEND_MAX_NODES else "bsr"
    if backend == "bsr" and cached and os.path.exists(cached_permutation_path(name)):
        dataset, reorder = reorder_cached(dataset, name), "none"
    print(f"RUNNING ON {device.type.upper()}")
    cfg = GCNConfig(epochs=args.epochs, seed=args.seed, graphsum_backend=backend,
                    reorder=reorder, early_stopping=args.early_stopping,
                    feature_matmul=args.feature_matmul, compute_dtype=args.compute_dtype)
    train.run(cfg, dataset, device=device, verbose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
