"""Training harness: train and eval steps and the fused epoch loop
(cuda_gcn_tpu/train.py).

Output contract of the reference (src/seq/gcn.cpp:139-157):

    epoch=%d train_loss=%.5f train_acc=%.5f val_loss=%.5f val_acc=%.5f time=%.5f
    total training time=%.5f
    test_loss=%.5f test_acc=%.5f time=%.5f

``run_epochs`` keeps the JAX package's pass fusion (cuda_gcn_tpu/train.py:110-156):
iteration i computes the training forward of epoch i and, in the same
width-concatenated adjacency passes, the validation forward of the weights
θ_{i-1}; a trailing eval supplies the last epoch's validation metrics and the
streams are realigned. That is 4 adjacency passes per epoch plus 2 for the
trailing eval. The loop is plain Python with no host synchronisation: the
metrics stay on the device until it ends.

``run_epochs_es`` is the early-stopping loop (:259-308): no pass fusion, since
the stop decision needs epoch e's validation loss before epoch e+1 starts, so
6 adjacency passes per epoch and one host read per epoch.

``prepare`` gives the model dense layer-0 features, or with
``feature_matmul='sparse'`` the CSR feature matrix (ops/matmul.py
``SparseFeatures``), which the reference program always uses, at any node
count: the JAX package's row bands from 2^19 rows on (``BandedFeatures``,
cuda_gcn_tpu/train.py:392-433) bound XLA temporaries that kernels 2 and 3
do not have, and the CSR product gives the banded result. The features
are cast to ``cfg.compute_dtype`` (:438-442), the graph is built for
activations of that type (bf16 edge coefficients for bf16), and
``create_state`` draws the weights in ``cfg.param_dtype``; the model then
gives each activation the JAX package's type, the loss and L2 are f32, and
Adam keeps f32 moments.

``run_epochs_chunked`` and ``run_epochs_es_chunked`` are the counterparts of
the JAX package's chunked device programs (:311-355). On the card the epoch
is a CUDA graph (graphs.py ``EpochGraph``): epoch 1 runs eagerly, then the
pass-fused epoch (or the early-stopping epoch: train step, eval, ring update
and stop flag) is captured once and replayed. Each epoch writes its metric
row into a device buffer at a row computed on the device from Adam's step
counter, so an epoch needs nothing from the host; the early-stopping loop
reads its 4-byte stop flag after every epoch, since a graph cannot stop
itself. A chunk is the number of epochs between two reads of the metrics by
the host, sized by the JAX package's policy (``run_chunked_loop``, :159-256),
so that both packages cut a run at the same epochs and time it the same way.
On the CPU the same chunks run eagerly. ``run_epochs`` and ``run_epochs_es``
stay the eager oracles.

``run`` brackets training and the test pass with the ``TMR_TRAIN`` and
``TMR_TEST`` phase timers (utils/timer.py) as the JAX package does
(:503-575): more than one epoch goes through the chunked runners, each
epoch's ``time`` the measured time of its chunk spread over the chunk's
epochs; a single epoch runs the stepwise train and eval steps. With
``time_ops`` it times every per-op phase afterwards (utils/profiling.py
``populate_op_timers``). ``prime_cache`` builds the libraries that a run
loads (:447-500).

Spans (utils/profiling.py ``span``, recorded only while a torch.profiler
session records): ``train.create_state``; ``train.epochs`` around each chunked
runner, with ``train.chunk_read`` around every read of a chunk's rows and
``train.trailing_eval`` (the fused loop) or ``train.stop_flag`` (the
early-stopping loop) inside it; ``train.eval`` around every ``eval_step``.
graphs.py adds ``graphs.eager`` and ``graphs.capture``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from cuda_gcn_torch import graphs, kernels
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data.dataset import GCNDataset
from cuda_gcn_torch.data.graph import DENSE_BACKEND_MAX_NODES, Graph, build_graph
from cuda_gcn_torch.data.reorder import locality_permutation, reorder_dataset
from cuda_gcn_torch.device import resolve_device
from cuda_gcn_torch.models.gcn import GCN
from cuda_gcn_torch.ops import adam
from cuda_gcn_torch.ops import matmul as matmul_ops
from cuda_gcn_torch.ops.loss import l2_penalty, masked_cross_entropy, strict_accuracy
from cuda_gcn_torch.utils.profiling import span
from cuda_gcn_torch.utils.timer import TMR_TEST, TMR_TRAIN, timers


@dataclasses.dataclass
class TrainState:
    model: GCN
    opt: adam.AdamState
    generator: torch.Generator  # dropout stream, on the model's device

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_state(cfg: GCNConfig, device: str | torch.device | None = None) -> TrainState:
    """Glorot weights in ``cfg.param_dtype`` drawn on the CPU from ``cfg.seed``
    (the same weights on every device), zero f32 Adam moments, and a dropout
    generator on the device."""
    device = resolve_device(device)
    with span("train.create_state"):
        model = GCN(cfg.layer_dims(), torch.Generator().manual_seed(cfg.seed),
                    getattr(torch, cfg.param_dtype)).to(device)
        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.seed + 1)
        return TrainState(model=model, opt=adam.init(dict(model.named_parameters())),
                          generator=generator)


def make_truth(split: np.ndarray, label: np.ndarray, current_split: int,
               device: str | torch.device) -> torch.Tensor:
    """set_truth (gcn.cpp:78-81): label where split matches, else -1."""
    return torch.from_numpy(np.where(split == current_split, label, -1)
                            .astype(np.int64)).to(device)


def _combined_metrics(logits, truth, w1, weight_decay):
    loss = masked_cross_entropy(logits, truth) + l2_penalty(w1, weight_decay)
    return loss, strict_accuracy(logits, truth)


def _adam_step(state: TrainState, lr: float) -> None:
    params = state.params()
    adam.step(params, {k: p.grad for k, p in params.items()}, state.opt,
              adam.AdamParams(lr=lr))


def train_step(state: TrainState, graph: Graph, x, truth, *, dropout_rate: float,
               weight_decay: float, lr: float):
    """One full-batch step (train_epoch, gcn.cpp:107-118): loss and accuracy at
    the pre-step weights on the dropout-active forward, then Adam."""
    state.model.zero_grad(set_to_none=True)
    loss, _, acc = state.model.loss_fn(graph, x, truth, weight_decay=weight_decay,
                                       dropout_rate=dropout_rate,
                                       generator=state.generator, training=True)
    loss.backward()
    _adam_step(state, lr)
    return loss.detach(), acc


@torch.no_grad()
def eval_step(model: GCN, graph: Graph, x, truth, *, weight_decay: float):
    """Evaluation forward (training=false): (loss incl. L2, acc) (gcn.cpp:120-128)."""
    with span("train.eval"):
        loss, _, acc = model.loss_fn(graph, x, truth, weight_decay=weight_decay)
        return loss, acc


def _fused_epoch(state: TrainState, graph: Graph, x, truth_train, truth_val, *,
                 dropout_rate: float, weight_decay: float, lr: float) -> torch.Tensor:
    """One pass-fused iteration (cuda_gcn_tpu/train.py:135-140): the training
    forward and the validation forward of the pre-step weights in the same
    adjacency passes, then Adam. Returns its row (train_loss, train_acc,
    val_loss, val_acc of the pre-step weights) on the device."""
    model = state.model
    model.zero_grad(set_to_none=True)
    logits_t, logits_e = model.apply_pair(graph, x, dropout_rate=dropout_rate,
                                          generator=state.generator)
    tl, ta = _combined_metrics(logits_t, truth_train, model.w1, weight_decay)
    with torch.no_grad():
        vl, va = _combined_metrics(logits_e, truth_val, model.w1, weight_decay)
    tl.backward()
    _adam_step(state, lr)
    return torch.stack([tl.detach(), ta, vl, va])


def _es_epoch(state: TrainState, graph: Graph, x, truth_train, truth_val, *,
              dropout_rate: float, weight_decay: float, lr: float) -> torch.Tensor:
    """One early-stopping iteration (:288-292): the train step, then the eval
    of the new weights; its row on the device."""
    tl, ta = train_step(state, graph, x, truth_train, dropout_rate=dropout_rate,
                        weight_decay=weight_decay, lr=lr)
    vl, va = eval_step(state.model, graph, x, truth_val, weight_decay=weight_decay)
    return torch.stack([tl, ta, vl, va])


def run_epochs(state: TrainState, graph: Graph, x, truth_train, truth_val, *,
               epochs: int, dropout_rate: float, weight_decay: float,
               lr: float) -> torch.Tensor:
    """``epochs`` pass-fused (train + validation) iterations, launched from
    Python; returns the metrics [epochs, 4] = (train_loss, train_acc,
    val_loss, val_acc) on the device, identical in value to ``train_step`` +
    ``eval_step`` per epoch."""
    kw = dict(dropout_rate=dropout_rate, weight_decay=weight_decay, lr=lr)
    rows = [_fused_epoch(state, graph, x, truth_train, truth_val, **kw)
            for _ in range(epochs)]
    if not rows:
        return torch.zeros(0, 4, device=truth_train.device)
    # realign: iteration i's validation metrics belong to θ_{i-1}; drop θ_0's
    # and append the trailing eval of the final weights
    vl_last, va_last = eval_step(state.model, graph, x, truth_val, weight_decay=weight_decay)
    m = torch.stack(rows)
    return torch.stack([m[:, 0], m[:, 1], torch.cat([m[1:, 2], vl_last[None]]),
                        torch.cat([m[1:, 3], va_last[None]])], dim=1)


def run_epochs_es(state: TrainState, graph: Graph, x, truth_train, truth_val, *,
                  epochs: int, es_window: int, dropout_rate: float, weight_decay: float,
                  lr: float) -> tuple[torch.Tensor, bool]:
    """Up to ``epochs`` (train step + eval) iterations with the reference's
    early stopping (gcn.cpp:142-150, cuda_gcn_tpu/train.py:261-308), launched
    from Python with one host read per epoch: after 1-based epoch e >=
    ``es_window``, stop when val_loss_e is above the mean of the last
    ``es_window`` val losses, the current one included. The losses sit in a
    ring of f32 slots, as in the JAX loop. Returns (metrics [epochs run, 4] on
    the device, stopped)."""
    kw = dict(dropout_rate=dropout_rate, weight_decay=weight_decay, lr=lr)
    ring = torch.full((es_window,), float("inf"), device=truth_train.device)
    rows = []
    stopped = False
    for i in range(epochs):
        rows.append(_es_epoch(state, graph, x, truth_train, truth_val, **kw))
        vl = rows[-1][2]
        epoch = i + 1
        ring[(epoch - 1) % es_window] = vl
        if epoch >= es_window and bool(vl > ring.mean()):
            stopped = True
            break
    if not rows:
        return torch.zeros(0, 4, device=truth_train.device), stopped
    return torch.stack(rows), stopped


# The chunk policy of the JAX package (cuda_gcn_tpu/train.py:159-256), with its
# constants, so that both packages cut a run at the same epochs. There it bounds
# the run time of one device program; here a chunk is the number of epochs
# (graph replays on the card) between two reads of the metrics by the host,
# which is also where a chunk's wall time is taken for the per-epoch ``time``.
TARGET_PROGRAM_SECONDS = 10.0
_EST_SECONDS_PER_EDGE_PASS = 5e-9
MAX_PROGRAM_SECONDS = 40.0
_PROBE_ABOVE_EST_SECONDS = 1.0


def _balance_chunks(epochs: int, raw: int) -> int:
    raw = max(1, min(epochs, raw))
    n_chunks = -(-epochs // raw)
    return -(-epochs // n_chunks)


def _estimate_epoch_seconds(nnz: int) -> float:
    return max(nnz * 4 * _EST_SECONDS_PER_EDGE_PASS, 1e-6)


def pick_epoch_chunk(nnz: int, epochs: int) -> int:
    per_epoch = _estimate_epoch_seconds(nnz)
    return _balance_chunks(epochs, int(TARGET_PROGRAM_SECONDS / per_epoch))


def run_chunked_loop(run_one, epochs: int, chunk: int | None, nnz: int,
                     passes_per_epoch: int = 4, times_out: list | None = None):
    """The JAX package's chunk policy (:165-256), as it is there.

    ``run_one(k)`` runs up to k epochs and returns the 4 per-epoch metric
    arrays, or ``(metrics, n_done, stopped)`` when the runner can stop early.
    Chunks are sized from the static per-edge estimate; above
    ``_PROBE_ABOVE_EST_SECONDS`` an epoch, two 1-epoch chunks are measured
    first and the rest sized from the second; a chunk measured over
    ``MAX_PROGRAM_SECONDS`` (not the first) shrinks the following ones.
    ``times_out``, a list, receives each chunk's measured wall time spread
    over its epochs, one value per epoch run. Returns (metrics [4 x
    np.ndarray], stopped)."""
    if epochs <= 0:
        return [np.zeros(0, np.float32) for _ in range(4)], False
    est = _estimate_epoch_seconds(nnz) * passes_per_epoch / 4
    probe = chunk is None and est > _PROBE_ABOVE_EST_SECONDS
    if chunk is None:
        chunk = _balance_chunks(epochs, int(TARGET_PROGRAM_SECONDS / est))
    parts: list[list[np.ndarray]] = []
    done = n_calls = 0
    stopped = False
    while done < epochs and not stopped:
        k = 1 if (probe and n_calls < 2) else min(chunk, epochs - done)
        t0 = time.perf_counter()
        out = run_one(k)
        if isinstance(out, tuple) and len(out) == 3:
            m, n_done, stopped = out
        else:
            m, n_done = out, k
        parts.append([np.asarray(v)[:n_done] for v in m])  # the host reads the chunk
        dt = time.perf_counter() - t0
        if times_out is not None and n_done:
            times_out.extend([dt / n_done] * n_done)
        done += n_done
        n_calls += 1
        if probe and n_calls == 2:
            chunk = _balance_chunks(epochs - done,
                                    int(TARGET_PROGRAM_SECONDS / max(dt, 1e-6)))
        elif n_calls > 1 and dt > MAX_PROGRAM_SECONDS and k > 1:
            chunk = max(1, int(MAX_PROGRAM_SECONDS / (dt / max(n_done, 1))))
    return [np.concatenate([p[i] for p in parts]) for i in range(4)], stopped


def _put_row(buf: torch.Tensor, row: torch.Tensor, values: torch.Tensor) -> None:
    """buf[row] = values, ``row`` a device int scalar: no host read."""
    buf.index_copy_(0, row.long().view(1), values.view(1, -1))


def _epoch_runner(step, state, graphed: bool, counters=None):
    """``step`` on the CPU; on the card an ``EpochGraph`` of it, drawing from
    the state's generator."""
    if not graphed:
        return step
    return graphs.EpochGraph(step, (state.generator,), counters).run


def chunked_fused_epochs(epoch, trailing_eval, state, nnz: int, *, epochs: int,
                         chunk: int | None = None, times_out: list | None = None,
                         graphed: bool, counters=None) -> torch.Tensor:
    """The chunked pass-fused loop of this module and of parallel/sharded.py:
    ``epoch()`` runs one pass-fused iteration (Adam included) and returns its
    row, ``trailing_eval()`` the (val loss, val acc) of the final weights.
    Row r of a device buffer takes iteration r's row, at r = Adam's step
    counter less its value at the start, minus one, computed on the device;
    the trailing eval fills row ``epochs``. ``graphed``: run the iterations
    as an ``EpochGraph``. Returns the realigned metrics [epochs, 4]."""
    with span("train.epochs"):
        device = state.opt.step.device
        buf = torch.zeros(epochs + 1, 4, device=device)
        base = state.opt.step.clone()

        def step():
            row = epoch()
            _put_row(buf, state.opt.step - base - 1, row)

        run = _epoch_runner(step, state, graphed, counters)
        done = 0

        def run_one(k):
            nonlocal done
            for _ in range(k):
                run()
            done += k
            with span("train.chunk_read"):
                return buf[done - k:done].T.cpu().numpy()

        run_chunked_loop(run_one, epochs, chunk, nnz, times_out=times_out)
        if not epochs:
            return torch.zeros(0, 4, device=device)
        with span("train.trailing_eval"):
            buf[epochs, 2:] = torch.stack(trailing_eval())
            return torch.stack([buf[:-1, 0], buf[:-1, 1], buf[1:, 2], buf[1:, 3]], dim=1)


def chunked_es_epochs(epoch, state, nnz: int, *, epochs: int, es_window: int,
                      chunk: int | None = None, times_out: list | None = None,
                      graphed: bool, counters=None) -> tuple[torch.Tensor, bool]:
    """The chunked early-stopping loop of this module and of
    parallel/sharded.py (cuda_gcn_tpu/train.py:259-337): ``epoch()`` runs the
    train step and the eval and returns their row. Each epoch also writes its
    val loss into the ring of ``es_window`` f32 slots and sets the stop flag,
    at the 1-based epoch e = Adam's step counter less its value at the start,
    on the device; the host reads the flag after each epoch. Returns (metrics
    [epochs run, 4], stopped)."""
    with span("train.epochs"):
        device = state.opt.step.device
        buf = torch.full((epochs, 4), float("inf"), device=device)
        ring = torch.full((es_window,), float("inf"), device=device)
        stop = torch.zeros((), dtype=torch.bool, device=device)
        base = state.opt.step.clone()

        def step():
            row = epoch()
            e = state.opt.step - base
            _put_row(buf, e - 1, row)
            ring.index_copy_(0, ((e - 1) % es_window).long().view(1), row[2:3])
            torch.logical_and(e >= es_window, row[2] > ring.mean(), out=stop)

        run = _epoch_runner(step, state, graphed, counters)
        done = 0

        def run_one(k):
            nonlocal done
            n, stopped = 0, False
            while n < k and not stopped:
                run()
                n += 1
                with span("train.stop_flag"):
                    stopped = bool(stop)  # the 4-byte flag: the host's one read an epoch
            done += n
            with span("train.chunk_read"):
                return buf[done - n:done].T.cpu().numpy(), n, stopped

        _, stopped = run_chunked_loop(run_one, epochs, chunk, nnz, passes_per_epoch=6,
                                      times_out=times_out)
        return buf[:done], stopped


def run_epochs_chunked(state: TrainState, graph: Graph, x, truth_train, truth_val, *,
                       epochs: int, chunk: int | None = None,
                       times_out: list | None = None, **step_kwargs) -> torch.Tensor:
    """``run_epochs`` in chunks (cuda_gcn_tpu/train.py:340-355), as a CUDA
    graph of the pass-fused epoch on the card (eagerly on the CPU), with one
    trailing eval. Returns the same [epochs, 4] metrics as ``run_epochs``."""
    kw = dict(step_kwargs)

    def epoch():
        return _fused_epoch(state, graph, x, truth_train, truth_val, **kw)

    def trailing_eval():
        return eval_step(state.model, graph, x, truth_val, weight_decay=kw["weight_decay"])

    return chunked_fused_epochs(epoch, trailing_eval, state, graph.total_nnz, epochs=epochs,
                                chunk=chunk, times_out=times_out,
                                graphed=truth_train.device.type == "cuda")


def run_epochs_es_chunked(state: TrainState, graph: Graph, x, truth_train, truth_val, *,
                          epochs: int, es_window: int, chunk: int | None = None,
                          times_out: list | None = None,
                          **step_kwargs) -> tuple[torch.Tensor, bool]:
    """``run_epochs_es`` in chunks (cuda_gcn_tpu/train.py:311-337), as a CUDA
    graph of the early-stopping epoch on the card (eagerly on the CPU): the
    same ring, the same epoch count across chunks, and the same stop; no
    epoch runs after it. Returns (metrics [epochs run, 4], stopped)."""
    def epoch():
        return _es_epoch(state, graph, x, truth_train, truth_val, **step_kwargs)

    return chunked_es_epochs(epoch, state, graph.total_nnz, epochs=epochs,
                             es_window=es_window, chunk=chunk, times_out=times_out,
                             graphed=truth_train.device.type == "cuda")


def prepare(cfg: GCNConfig, dataset: GCNDataset, device: str | torch.device | None = None):
    """Device-resident graph, features (a dense [N, F] tensor, or
    ``SparseFeatures`` when ``cfg.feature_matmul`` is 'sparse') and per-split
    truth vectors.

    For the bsr backend the dataset is first relabelled with the locality
    permutation (data/reorder.py) unless ``cfg.reorder`` is 'none', as in
    cuda_gcn_tpu/train.py:382-386; a dataset already relabelled from the
    cached permutation (data.dataset ``reorder_cached``) passes 'none'."""
    device = resolve_device(device)
    cfg = dataset.apply_config(cfg)
    act = getattr(torch, cfg.compute_dtype)  # 'float32' or 'bfloat16' (config.DTYPES)
    itemsize = torch.empty(0, dtype=act).element_size()
    if cfg.feature_matmul not in ("dense", "sparse"):
        raise ValueError(f"feature_matmul must be 'dense' or 'sparse', got "
                         f"{cfg.feature_matmul!r}")
    sparse = cfg.feature_matmul == "sparse"
    backend = cfg.graphsum_backend
    if backend == "auto":
        backend = "dense" if cfg.num_nodes <= DENSE_BACKEND_MAX_NODES else "bsr"
    if backend == "bsr" and cfg.reorder != "none":
        dataset = reorder_dataset(dataset, locality_permutation(dataset.graph))
    if device.type == "cuda":
        kernels.build()
    budget = None if cfg.bsr_budget_gb is None else int(cfg.bsr_budget_gb * (1 << 30))
    # feature bytes declared to the tile budget: the value, row and column of
    # each nnz on the sparse path, or dense x (cuda_gcn_tpu/train.py:392-405),
    # at the compute type's size. The JAX package declares 1.1x that for its
    # bands from 2^19 rows on, to cover their padding; CSR has none at any size.
    feat_bytes = (len(dataset.feature_value) * (itemsize + 8) if sparse
                  else dataset.num_nodes * cfg.input_dim * itemsize)
    graph = build_graph(dataset.graph, backend=backend, bsr_budget_bytes=budget,
                        aux_bytes=feat_bytes, act_itemsize=itemsize, device=device)
    if sparse:
        fi = dataset.feature_index
        x = matmul_ops.SparseFeatures.from_csr(fi.indptr, fi.indices, dataset.feature_value,
                                               cfg.input_dim, device, act)
    else:
        x = torch.from_numpy(dataset.dense_features(np.float32)).to(device).to(act)
    truths = {s: make_truth(dataset.split, dataset.label, s, device) for s in (1, 2, 3)}
    return cfg, graph, x, truths


@dataclasses.dataclass
class RunResult:
    test_loss: float
    test_acc: float
    total_train_time: float
    epochs_run: int
    state: TrainState
    history: list[dict]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def report_epochs(rows, times, verbose: bool) -> list[dict]:
    """The history of a run from its metric rows and per-epoch seconds, each
    epoch printed in the reference's format when ``verbose``."""
    history = []
    for epoch, ((tl, ta, vl, va), t) in enumerate(zip(rows, times), start=1):
        if verbose:
            print(f"epoch={epoch} train_loss={tl:.5f} train_acc={ta:.5f} "
                  f"val_loss={vl:.5f} val_acc={va:.5f} time={t:.5f}")
        history.append(dict(epoch=epoch, train_loss=tl, train_acc=ta, val_loss=vl,
                            val_acc=va, time=t))
    return history


def run(cfg: GCNConfig, dataset: GCNDataset, device: str | torch.device | None = None,
        verbose: bool = True, initial_state: TrainState | None = None,
        time_ops: bool = False) -> RunResult:
    """Full training run with the reference's output contract, from
    ``initial_state`` when given (cuda_gcn_tpu/train.py:503-575). More than
    one epoch runs through ``run_epochs_chunked``, or with
    ``cfg.early_stopping > 0`` ``run_epochs_es_chunked``: CUDA graphs on the
    card, each epoch's ``time`` measured per chunk. One epoch runs the
    stepwise train and eval steps, timed alone. ``time_ops`` then measures
    every per-op phase at the run's shapes (utils/profiling.py), for
    ``timers.report()``."""
    device = resolve_device(device)
    cfg, graph, x, truths = prepare(cfg, dataset, device)
    timers.reset(TMR_TRAIN, TMR_TEST)  # per-run totals
    state = initial_state if initial_state is not None else create_state(cfg, device)
    kw = dict(dropout_rate=cfg.dropout, weight_decay=cfg.weight_decay, lr=cfg.learning_rate)
    stopped = False
    _sync(device)
    if cfg.epochs > 1:
        timers.start(TMR_TRAIN)
        times: list[float] = []
        if cfg.early_stopping > 0:
            metrics, stopped = run_epochs_es_chunked(
                state, graph, x, truths[1], truths[2], epochs=cfg.epochs,
                es_window=cfg.early_stopping, times_out=times, **kw)
        else:
            metrics = run_epochs_chunked(state, graph, x, truths[1], truths[2],
                                         epochs=cfg.epochs, times_out=times, **kw)
        timers.stop(TMR_TRAIN, sync=metrics)
        history = report_epochs(metrics.tolist(), times, verbose)
    else:
        history = []
        for _ in range(cfg.epochs):
            timers.start(TMR_TRAIN)
            row = _es_epoch(state, graph, x, truths[1], truths[2], **kw).tolist()
            history += report_epochs([row], [timers.stop(TMR_TRAIN)], verbose)
    total = timers.total(TMR_TRAIN)
    if verbose:
        if stopped:
            print("Early stopping...")
        print(f"total training time={total:.5f}")
    timers.start(TMR_TEST)
    test_loss, test_acc = eval_step(state.model, graph, x, truths[3],
                                    weight_decay=cfg.weight_decay)
    test_time = timers.stop(TMR_TEST, sync=test_loss)
    test_loss, test_acc = float(test_loss), float(test_acc)
    if verbose:
        print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f} time={test_time:.5f}")
    if time_ops:
        from cuda_gcn_torch.utils.profiling import populate_op_timers

        populate_op_timers(graph, x, state.params(), truths[1], cfg.seed,
                           dropout_rate=cfg.dropout)
    return RunResult(test_loss=test_loss, test_acc=test_acc, total_train_time=total,
                     epochs_run=len(history), state=state, history=history)


def prime_cache(cfg: GCNConfig, dataset: GCNDataset,
                device: str | torch.device | None = None,
                verbose: bool = True) -> list[tuple[str, float]]:
    """Build what a run loads and what outlives its process, without training
    (cuda_gcn_tpu/train.py:447-500, which compiles XLA programs into the
    persistent cache): on ``cuda`` the nvcc libraries of every kernel source
    (``kernels.build``; ``prepare`` loads all of them), and the g++ libraries
    of the native host code (data/native.py). Each library lands where the
    next process looks for it (``kernels.BUILD_DIR``, ``native.BUILD_DIR``;
    the CLI's ``--compilation-cache``). A library already built costs nothing
    and is listed with its 0 seconds. Nothing built depends on ``cfg`` or
    ``dataset``, taken as the JAX function takes them: a kernel library holds
    every width and type, a host library any input. The CUDA graphs of the
    epoch are not primed: a graph does not outlive its process, and each run
    captures its own after its first epoch. Returns [(library, seconds)]."""
    from cuda_gcn_torch.data import native

    device = resolve_device(device)
    built = []
    if device.type == "cuda":
        report = kernels.build()
        built += [(os.path.basename(kernels._lib_path(n)),
                   report[n]["seconds"] if n in report else 0.0) for n in kernels.SOURCES]
    seconds = native.build()
    built += [(os.path.basename(native.lib_path(n)), seconds.get(n, 0.0))
              for n in native.SOURCES]
    if verbose:
        for name, s in built:
            print(f"primed {name} in {s:.1f}s")
    return built
