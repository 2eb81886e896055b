"""The system under test, ``cuda_gcn_torch``, as the benchmark drives it.

The only module of the benchmark that imports the program, and only inside
its functions. A training job makes the calls ``train.run`` makes, without
its printing: ``train.create_state`` for the job's seed, then
``train.run_epochs_chunked`` (``train.run_epochs_es_chunked`` with early
stopping), then ``train.eval_step`` on the test split, its results read back
by the host.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from benchmark.reference import Readings


def use_cache_dirs(root: str) -> None:
    """Point every build and kernel cache of the program at fixed directories
    under ``root``: nvcc and g++ libraries in ``root``/{kernels,native}
    (``utils.compile_cache.use_build_dir``), Triton's cache in ``root``/triton."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "triton")
    from cuda_gcn_torch.utils.compile_cache import use_build_dir

    use_build_dir(root)


def dataset_of(data: dict):
    from cuda_gcn_torch.data.dataset import CSR, GCNDataset

    return GCNDataset(graph=CSR(data["indptr"], data["indices"]),
                      feature_index=CSR(data["f_indptr"], data["f_indices"]),
                      feature_value=data["f_values"], label=data["label"],
                      split=data["split"], num_nodes=int(data["num_nodes"]),
                      input_dim=int(data["input_dim"]), output_dim=int(data["output_dim"]))


@dataclasses.dataclass
class Prepared:
    """What ``train.prepare`` gives, shared by every job of a run."""

    cfg: object
    graph: object
    x: object
    truths: dict
    device: torch.device

    @property
    def early_stopping(self) -> bool:
        return self.cfg.early_stopping > 0


def prepare(config: dict, traffic: dict, data: dict, device: str = "cuda") -> Prepared:
    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig

    model = config["model"]
    cfg = GCNConfig(hidden_dim=model["hidden_dim"], dropout=model["dropout"],
                    learning_rate=model["learning_rate"],
                    weight_decay=model["weight_decay"], epochs=traffic["epochs"],
                    early_stopping=traffic["early_stopping"],
                    graphsum_backend=config["graphsum_backend"],
                    compute_dtype=config["compute_dtype"],
                    param_dtype=config["param_dtype"],
                    feature_matmul=traffic["feature_matmul"])
    cfg, graph, x, truths = train.prepare(cfg, dataset_of(data), device)
    return Prepared(cfg=cfg, graph=graph, x=x, truths=truths, device=torch.device(device))


def _train(p: Prepared, state, epochs: int, dropout: float):
    from cuda_gcn_torch import train

    kw = dict(dropout_rate=dropout, weight_decay=p.cfg.weight_decay,
              lr=p.cfg.learning_rate)
    if p.early_stopping:
        metrics, _ = train.run_epochs_es_chunked(
            state, p.graph, p.x, p.truths[1], p.truths[2], epochs=epochs,
            es_window=p.cfg.early_stopping, **kw)
        return metrics
    return train.run_epochs_chunked(state, p.graph, p.x, p.truths[1], p.truths[2],
                                    epochs=epochs, **kw)


def run_job(p: Prepared, seed: int) -> tuple[int, bool]:
    """One training job at the cell's settings: (epochs run, whether every
    number it reported is finite)."""
    from cuda_gcn_torch import train

    state = train.create_state(dataclasses.replace(p.cfg, seed=seed), p.device)
    metrics = _train(p, state, p.cfg.epochs, p.cfg.dropout).cpu()
    test_loss, test_acc = train.eval_step(state.model, p.graph, p.x, p.truths[3],
                                          weight_decay=p.cfg.weight_decay)
    finite = bool(torch.isfinite(metrics).all()) and math.isfinite(float(test_loss)) \
        and math.isfinite(float(test_acc))
    return len(metrics), finite


class _MaskReader:
    """Reads the dropout masks of a training step back from the tensors its
    forward saves for the backward pass (``torch.autograd.graph.
    saved_tensors_hooks``), whatever op saved them: the layer-0 product's
    dropped operand (a float tensor of X's shape: [N, F] dense, or X's nnz
    values, [nnz] or [nnz, 1]) opens a step, whose kept mask is where it is
    not 0, read at X's nnz; the hidden layer's is where the [N, H] float
    tensor saved with the fewest nonzeros is not 0 (the dropped operand of
    the output layer's product; a ReLU's saved result has twice as many).
    A mask read during a CUDA graph's capture holds the values of the
    graph's replays, so it is read after the call."""

    def __init__(self, p: Prepared, data: dict):
        x = p.x
        self.dense = isinstance(x, torch.Tensor)
        if self.dense:  # X's nnz in CSR order, as positions in the flat dense X
            f_indptr = data["f_indptr"].astype(np.int64)
            rows = np.repeat(np.arange(len(f_indptr) - 1, dtype=np.int64), np.diff(f_indptr))
            self.at = torch.from_numpy(rows * x.shape[1] + data["f_indices"]).to(x.device)
        self.x_shapes = {tuple(x.shape)} if self.dense else {(x.nnz,), (x.nnz, 1)}
        self.hidden_shape = (int(data["num_nodes"]), p.cfg.hidden_dim)
        self.steps: list[list] = []

    def pack(self, t: torch.Tensor):
        if t.is_floating_point():
            shape = tuple(t.shape)
            if shape in self.x_shapes:
                flat = t.reshape(-1)
                self.steps.append([(flat[self.at] if self.dense else flat) != 0, []])
            elif shape == self.hidden_shape and self.steps:
                self.steps[-1][1].append(t != 0)
        return t

    def masks(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Each step's (X's kept nnz, the hidden layer's kept mask), on the
        host; a step with no hidden candidate keeps an empty mask."""
        out = []
        for x_kept, hidden in self.steps:
            h = min(hidden, key=lambda m: int(m.sum())) if hidden else torch.zeros(0, dtype=bool)
            out.append((x_kept.cpu(), h.cpu()))
        return out


def check_steps(p: Prepared, data: dict, seed: int) -> Readings:
    """The first three steps of a job of ``seed`` through the window's own
    calls at the cell's dropout: one epoch, then two more from the state it
    left (an eager epoch and one CUDA graph capture and replay), and the
    test evaluation. The first gradient is read from Adam's first moment
    after one step (m = (1-β1)·g); each step's dropout masks are read back
    (``_MaskReader``) for the reference to apply."""
    from cuda_gcn_torch import train
    from cuda_gcn_torch.ops.adam import AdamParams

    state = train.create_state(dataclasses.replace(p.cfg, seed=seed), p.device)
    names = [n for n, _ in state.model.named_parameters()]
    w0 = [w.detach().float().cpu().clone() for w in state.model.weights()]
    reader = _MaskReader(p, data)
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        first = _train(p, state, 1, p.cfg.dropout).cpu().numpy()
        beta1 = AdamParams().beta1
        grad1 = [state.opt.m[n].detach().cpu() / (1.0 - beta1) for n in names]
        rest = _train(p, state, 2, p.cfg.dropout).cpu().numpy()
    test_loss, _ = train.eval_step(state.model, p.graph, p.x, p.truths[3],
                                   weight_decay=p.cfg.weight_decay)
    rows = np.concatenate([first, rest])
    change = [w.detach().float().cpu() - a for w, a in zip(state.model.weights(), w0)]
    return Readings(train_loss=[float(v) for v in rows[:, 0]],
                    val_loss=[float(v) for v in rows[:, 2]], test_loss=float(test_loss),
                    grad1=grad1, change=change, masks=reader.masks())
