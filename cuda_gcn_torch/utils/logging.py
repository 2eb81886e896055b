"""Per-epoch history as CSV or JSONL, and the gradient norm
(cuda_gcn_tpu/utils/logging.py). The files are byte for byte what the JAX
package writes for the same history."""

from __future__ import annotations

import csv
import json

import torch

FIELDS = ["epoch", "train_loss", "train_acc", "val_loss", "val_acc", "time"]


def grad_norm(grads: dict[str, torch.Tensor]) -> float:
    """L2 norm over a dict of gradients, each squared and summed in f32
    (the reference's Variable::grad_norm, src/seq/variable.cpp:36-43)."""
    if not grads:
        return 0.0
    return float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values())))


def write_history_csv(path: str, history: list[dict]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        for row in history:
            w.writerow({k: row[k] for k in FIELDS})


def write_history_jsonl(path: str, history: list[dict], run_meta: dict | None = None) -> None:
    """One JSON object per epoch, after a first line ``{"meta": run_meta}``."""
    with open(path, "w") as f:
        if run_meta:
            f.write(json.dumps({"meta": run_meta}) + "\n")
        for row in history:
            f.write(json.dumps(row) + "\n")
