"""Sharded training over torch.distributed: the halo-exchange GCN, one part per rank.

The port of cuda_gcn_tpu/parallel/sharded.py. The JAX package runs one SPMD
program over a device mesh (``shard_map``, ``ppermute``, ``psum``); here every
rank is a process with its own part on its own device, in a process group
(``parallel/multihost.py``) whose world size is the part count:

* rank p holds the [block, d] slab of its nodes and the interior and boundary
  operators of its edges (parallel/partition.py ``PartView``): the interior a
  ``Graph`` on bsr (kernel 1 tiles, kernel 2 residual) or segment (kernel 2),
  the boundary a rectangular kernel 2 CSR over the halo rows;
* per layer, ``HaloExchange`` runs the JAX package's P-1 ring rounds (round k
  ships rank q's rows ``send_secs[k-1]`` to (q+k) % P) as one
  ``batch_isend_irecv``; the interior aggregation is launched between the
  issue and the wait, which is the JAX overlap (:136-166); payloads cross in
  ``halo_dtype`` both ways (``_cast_payload``);
* the backward is written by hand (``_HaloSum``): the boundary transpose into
  the halo rows, the inverse rounds while the interior transpose runs, then
  ``index_add_`` of what comes back onto the senders' rows (:197-220). The pair
  of the fused loop aggregates (train, eval) at the concatenated width and
  differentiates at train width only;
* the weights are replicated: every rank backpropagates its own masked CE sum
  over the global count, one all-reduce (SUM) per step sums the flat gradient
  together with the step's metric sums (CE sum and correct count of each
  half, ``_psum_metrics`` :275), the L2 gradient is added once after it (the
  JAX package adds L2 outside ``shard_map``, :371), and every rank runs the
  same Adam step. The loop keeps the metrics on the device;
* dropout draws from each rank's own generator, seeded from (seed, rank)
  (``rank_generator``; the JAX package folds the rank into the key, :250).

Transport: NCCL (one card per rank) takes the card's tensors. Gloo's send
and recv read and write a tensor's memory from the host, so under gloo a
payload on a card is staged explicitly through pinned host buffers
(``HaloExchange(stage_host=True)``, chosen by ``shard_inputs`` from the
device and the backend); compute stays on the card, and the
backend is the caller's choice, never switched silently. Gloo's all-reduce
takes CUDA tensors itself.

The chunked runners ``run_epochs_chunked`` and ``run_epochs_es_chunked``
(:489-515, 569-600) share train.py's chunk policy and loops. Under NCCL (or
with no process group) on the card each rank's epoch is a CUDA graph
(graphs.py ``EpochGraph``), captured after the eager epoch 1: the capture
holds the halo rounds' ``batch_isend_irecv`` and the epoch's all-reduce,
which NCCL enqueues on the capturing stream. Under gloo the exchange is
staged through pinned host memory with a stream synchronisation
(``HaloExchange.start``), which a capture cannot hold, so there the chunked
runners run eagerly. ``dist.get_backend()`` decides this (``_graphed``); a
capture that fails raises. The mesh (``make_mesh``) is the process group.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.data.dataset import GCNDataset, reorder_dataset
from cuda_gcn_torch.data.graph import (DENSE_BACKEND_MAX_NODES, Graph, _residual_csr)
from cuda_gcn_torch.device import resolve_device
from cuda_gcn_torch.models.gcn import _layer0_transform
from cuda_gcn_torch.ops import adam
from cuda_gcn_torch.ops.bsr import tile_plan
from cuda_gcn_torch.ops.dropout import dropout
from cuda_gcn_torch.ops.graphsum import RectGraph, rect_apply
from cuda_gcn_torch.ops.loss import l2_penalty
from cuda_gcn_torch.ops.matmul import (SparseFeatures, dense_matmul,
                                       make_sparse_features_parts, slice_feature_rows)
from cuda_gcn_torch.parallel.partition import PartView, partition_graph

# rank r's dropout seed is the single-device seed plus r times this (mod 2^32)
RANK_SEED_STRIDE = 1 << 24


def _cast_payload(a: torch.Tensor, halo_dtype: str) -> torch.Tensor:
    """The wire type of a halo payload (:57-66): bf16 halves each round's
    bytes; the receiver casts back and sums in f32."""
    dt = getattr(torch, halo_dtype)
    return a if a.dtype == dt else a.to(dt)


class _Pending:
    """The rounds of one exchange in flight; ``wait`` returns what arrived."""

    def __init__(self, works, recv, host_recv=None):
        self.works, self.recv, self.host_recv = works, recv, host_recv

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.host_recv is not None:
            self.recv.copy_(self.host_recv, non_blocking=True)
        return self.recv


class HaloExchange:
    """One rank's P-1 ring rounds over ``sections`` (the JAX ``ppermute``s,
    :157-163). A payload is [sum(sections), d], section k-1 being round k's:
    ``start`` ships it to (rank + k) % P and receives the same section from
    (rank - k) % P; ``start(inverse=True)`` runs the rounds backwards.

    ``stage_host``: the payload is on a card and the backend (gloo) sends and
    receives host memory. The payload is then copied to a pinned host buffer,
    the copy awaited, the rounds run on host buffers, and what arrives is
    copied back to the card. ``sent`` counts the rows and bytes this rank
    has shipped (an ``EpochGraph`` counter: a replay adds its epoch's)."""

    def __init__(self, rank: int, world_size: int, sections: tuple, stage_host: bool = False):
        self.rank, self.world_size = rank, world_size
        self.sections = tuple(int(s) for s in sections)
        self.bounds = np.concatenate([[0], np.cumsum(self.sections, dtype=np.int64)]).tolist()
        self.stage_host = stage_host
        self.sent = {"rows": 0, "bytes": 0}
        self._pinned: dict = {}

    @property
    def rounds(self) -> int:
        return len(self.sections)

    @property
    def sent_rows(self) -> int:
        return self.sent["rows"]

    @property
    def sent_bytes(self) -> int:
        return self.sent["bytes"]

    def _host(self, role: str, like: torch.Tensor) -> torch.Tensor:
        key = (role, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(like.shape, dtype=like.dtype,
                                                  pin_memory=True)
        return buf

    def start(self, send: torch.Tensor, inverse: bool = False) -> _Pending:
        send = send.contiguous()
        recv = torch.empty_like(send)
        src, dst, host_recv = send, recv, None
        if self.stage_host:
            src = self._host("send", send)
            src.copy_(send, non_blocking=True)
            torch.cuda.current_stream(send.device).synchronize()  # the copy has landed
            dst = host_recv = self._host("recv", send)
        ops = []
        for k in range(1, self.rounds + 1):
            a, b = self.bounds[k - 1], self.bounds[k]
            to, frm = (self.rank + k) % self.world_size, (self.rank - k) % self.world_size
            if inverse:
                to, frm = frm, to
            ops.append(dist.P2POp(dist.isend, src[a:b], to))
            ops.append(dist.P2POp(dist.irecv, dst[a:b], frm))
        self.sent["rows"] += send.shape[0]
        self.sent["bytes"] += send.numel() * send.element_size()
        return _Pending(dist.batch_isend_irecv(ops), recv, host_recv)


@dataclasses.dataclass
class ShardedInputs:
    """One rank's device inputs (:78-104): its interior and boundary
    operators, its send lists, its feature slab and its exchange."""

    interior: RectGraph          # [B, B]
    boundary: RectGraph          # [B, halo_space]
    send_secs: list              # P-1 int64 tensors [hmax_k]: block rows shipped in round k
    send_idx: torch.Tensor       # their concatenation [sum hmax_k]
    x: torch.Tensor | SparseFeatures  # [B, F] dense slab, or the part's CSR rows
    block: int
    exchange: HaloExchange
    # eimax + ebmax, one part's padded edge slots (tile-covered edges not
    # counted), the same on every rank: the chunk policy's measure of an
    # epoch, as the JAX runners take it (:499-501)
    edge_capacity: int


def _interior_graph(part: PartView, device, coef_dtype) -> Graph:
    """The part's square interior as a port Graph: bsr with its tiles, or
    segment; both orientations built (the tiles are not pair-closed)."""
    b = part.block
    tile_edges = len(part.tile_vals) if part.tb else 0
    graph = Graph(n_nodes=b, backend="segment", symmetric=False,
                  total_nnz=len(part.interior[0]) + tile_edges,
                  resid=_residual_csr(*part.interior, b, device, coef_dtype),
                  resid_t=_residual_csr(*part.interior_t, b, device, coef_dtype))
    if part.tb:
        graph.backend = "bsr"
        graph.tiles = part.tiles(device)
        graph.tile_rows = torch.from_numpy(part.tile_rows).to(device)
        graph.tile_cols = torch.from_numpy(part.tile_cols).to(device)
        graph.tb, graph.t_blocks = part.tb, part.nblocks
        graph.plan = tile_plan(graph.tile_rows, graph.tile_cols, part.nblocks)
        graph.plan_t = tile_plan(graph.tile_cols, graph.tile_rows, part.nblocks)
    return graph


def make_sharded_inputs(part: PartView, x, device, exchange: HaloExchange,
                        act_dtype: torch.dtype = torch.float32) -> ShardedInputs:
    """Put one part on ``device`` (:374-422). ``x`` is the part's dense
    [block, F] slab (numpy) or its ``SparseFeatures``; the edge coefficients
    are bf16 for bf16 activations, as data/graph.py stores them."""
    device = torch.device(device)
    coef_dtype = torch.bfloat16 if act_dtype == torch.bfloat16 else torch.float32
    interior = RectGraph(n_out=part.block, n_in=part.block,
                         square=_interior_graph(part, device, coef_dtype))
    boundary = RectGraph(
        n_out=part.block, n_in=part.halo_space,
        resid=_residual_csr(*part.boundary, part.block, device, coef_dtype),
        resid_t=_residual_csr(*part.boundary_t, part.halo_space, device, coef_dtype))
    secs = [torch.from_numpy(s.astype(np.int64)).to(device) for s in part.send_secs]
    send_idx = (torch.cat(secs) if secs else torch.zeros(0, dtype=torch.int64, device=device))
    if not isinstance(x, SparseFeatures):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device).to(act_dtype)
    return ShardedInputs(interior=interior, boundary=boundary, send_secs=secs,
                         send_idx=send_idx, x=x, block=part.block, exchange=exchange,
                         edge_capacity=part.edge_capacity)


class _HaloSum(torch.autograd.Function):
    """Sharded aggregation of zt, or of [zt | ze] at the concatenated width
    (the pair, :169-223), whose backward runs at zt's width only."""

    @staticmethod
    def forward(ctx, zt, ze, inputs: ShardedInputs, halo_dtype: str):
        ctx.inputs, ctx.halo_dtype = inputs, halo_dtype
        both = zt if ze is None else torch.cat([zt, ze], dim=1)
        ex = inputs.exchange
        pending = (ex.start(_cast_payload(both[inputs.send_idx], halo_dtype))
                   if ex.rounds else None)
        out = rect_apply(both, inputs.interior, transpose=False)  # while the rounds fly
        if pending is not None:  # P = 1 has no halo and no boundary edges
            halo = pending.wait().to(both.dtype)
            out = rect_apply(halo, inputs.boundary, transpose=False, out=out)
        if ze is None:
            return out
        d = zt.shape[1]
        out_t, out_e = out[:, :d].contiguous(), out[:, d:].contiguous()
        ctx.mark_non_differentiable(out_e)
        return out_t, out_e

    @staticmethod
    def backward(ctx, g_t, g_e=None):
        """The transpose at train width: boundary transpose into the halo
        rows, the inverse rounds while the interior transpose runs, then each
        round's cotangents added onto the rows that were shipped (a padding
        slot ships row 0 and gets back exactly 0: no boundary edge reads a
        padding halo row)."""
        inputs = ctx.inputs
        g = g_t.contiguous()
        ex = inputs.exchange
        pending = None
        if ex.rounds:
            g_halo = rect_apply(g, inputs.boundary, transpose=True)  # [halo_space, d]
            pending = ex.start(_cast_payload(g_halo, ctx.halo_dtype), inverse=True)
        d_own = rect_apply(g, inputs.interior, transpose=True)
        if pending is not None:
            back = pending.wait()
            for k, sidx in enumerate(inputs.send_secs):
                a, b = ex.bounds[k], ex.bounds[k + 1]
                d_own.index_add_(0, sidx, back[a:b].to(d_own.dtype))
        return d_own, None, None, None


def halo_graphsum(own_h: torch.Tensor, inputs: ShardedInputs,
                  halo_dtype: str = "float32") -> torch.Tensor:
    """One sharded aggregation of this rank's [B, d] slab (:136-166): the
    exchange in flight while the interior is aggregated, then the boundary
    added; [B, d] in own_h's type."""
    return _HaloSum.apply(own_h, None, inputs, halo_dtype)


def halo_graphsum_pair(zt, ze, inputs: ShardedInputs, halo_dtype: str = "float32"):
    """(halo_graphsum(zt), halo_graphsum(ze)) in one exchange and one
    aggregation at the concatenated width, differentiated at train width
    (:226-234); the eval half is detached."""
    out_t, out_e = _HaloSum.apply(zt, ze.detach(), inputs, halo_dtype)
    return out_t, out_e.detach()


def _forward(model, inputs: ShardedInputs, dropout_rate: float, generator,
             training: bool, halo_dtype: str) -> torch.Tensor:
    """The rank's GCN forward on its slab (:237-272): [B, C] logits."""
    h = inputs.x
    weights = model.weights()
    for i, w in enumerate(weights):
        if i == 0:
            z = _layer0_transform(h, w, dropout_rate, generator, training)
        else:
            z = dense_matmul(dropout(h, dropout_rate, generator, training), w)
        h = halo_graphsum(z, inputs, halo_dtype)
        if i < len(weights) - 1:
            h = torch.relu(h)
    return h


def _forward_pair(model, inputs: ShardedInputs, dropout_rate: float, generator,
                  halo_dtype: str):
    """The fused train (dropout) and eval forwards on the slab (:301-332)."""
    ht = he = inputs.x
    weights = model.weights()
    for i, w in enumerate(weights):
        if i == 0:
            zt = _layer0_transform(ht, w, dropout_rate, generator, True)
            with torch.no_grad():
                ze = _layer0_transform(he, w, 0.0, None, False)
        else:
            zt = dense_matmul(dropout(ht, dropout_rate, generator, True), w)
            with torch.no_grad():
                ze = dense_matmul(he, w)
        ht, he = halo_graphsum_pair(zt, ze, inputs, halo_dtype)
        if i < len(weights) - 1:
            ht, he = torch.relu(ht), torch.relu(he)
    return ht, he


def _local_metrics(logits: torch.Tensor, truth: torch.Tensor):
    """(masked CE sum, correct count) over this rank's rows, f32 scalars;
    summed over ranks they are ``_psum_metrics``'s (:275-291)."""
    mask = truth >= 0
    safe = torch.where(mask, truth, torch.zeros_like(truth)).long()
    logits32 = logits.float()
    shifted = logits32 - logits32.max(dim=1, keepdim=True).values.detach()
    log_z = torch.log(torch.exp(shifted).sum(dim=1))
    per_node = log_z - shifted.gather(1, safe[:, None])[:, 0]
    ce_sum = torch.where(mask, per_node, torch.zeros_like(per_node)).sum()
    truth_logit = logits.gather(1, safe[:, None])[:, 0]
    correct = (mask & (logits.max(dim=1).values <= truth_logit)).float().sum()
    return ce_sum, correct


@dataclasses.dataclass
class ShardedTruth:
    """One split's truth rows of this rank ([B], -1 on padding rows) and the
    split's node count over all ranks."""

    rows: torch.Tensor
    count: int


def _all_reduce(buf: torch.Tensor) -> torch.Tensor:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(buf)
    return buf


def _reduce_step(model, sums: list, weight_decay: float) -> torch.Tensor:
    """One all-reduce of this rank's flat gradient (p.grad of every weight,
    in f32) and of ``sums``; the summed gradients go back to p.grad with the
    L2 gradient of w1 added once. Returns the summed ``sums``."""
    weights = model.weights()
    buf = torch.cat([w.grad.reshape(-1).float() for w in weights]
                    + [torch.stack([s.float() for s in sums])])
    _all_reduce(buf)
    off = 0
    for i, w in enumerate(weights):
        g = buf[off: off + w.numel()].view(w.shape)
        if i == 0 and weight_decay:
            g = g + weight_decay * w.detach().float()
        w.grad = g.to(w.dtype)
        off += w.numel()
    return buf[off:]


def _adam_step(state, lr: float) -> None:
    params = state.params()
    adam.step(params, {k: p.grad for k, p in params.items()}, state.opt,
              adam.AdamParams(lr=lr))


def loss_and_grads(state, inputs: ShardedInputs, truth: ShardedTruth, cfg: GCNConfig):
    """(loss incl. L2, accuracy) over all ranks of the dropout-active
    forward, with the gradient of that loss, summed over ranks and L2
    included, left in each weight's ``.grad``."""
    model = state.model
    model.zero_grad(set_to_none=True)
    logits = _forward(model, inputs, cfg.dropout, state.generator, True, cfg.halo_dtype)
    ce, correct = _local_metrics(logits, truth.rows)
    (ce / truth.count).backward()
    l2 = l2_penalty(model.w1, cfg.weight_decay).detach()
    sums = _reduce_step(model, [ce.detach(), correct], cfg.weight_decay)
    return sums[0] / truth.count + l2, sums[1] / truth.count


def train_step(state, inputs: ShardedInputs, truth: ShardedTruth, cfg: GCNConfig):
    """One sharded step (:425-443): (loss incl. L2, accuracy) at the pre-step
    weights on the dropout-active forward, then Adam on every rank."""
    loss, acc = loss_and_grads(state, inputs, truth, cfg)
    _adam_step(state, cfg.learning_rate)
    return loss, acc


@torch.no_grad()
def eval_step(model, inputs: ShardedInputs, truth: ShardedTruth, cfg: GCNConfig):
    """Evaluation forward (:600-608): (loss incl. L2, accuracy), one
    all-reduce of the two sums."""
    logits = _forward(model, inputs, 0.0, None, False, cfg.halo_dtype)
    sums = _all_reduce(torch.stack(_local_metrics(logits, truth.rows)))
    return (sums[0] / truth.count + l2_penalty(model.w1, cfg.weight_decay),
            sums[1] / truth.count)


def _fused_epoch(state, inputs: ShardedInputs, truth_train: ShardedTruth,
                 truth_val: ShardedTruth, cfg: GCNConfig) -> torch.Tensor:
    """One pass-fused iteration on this rank (:446-486): the train forward
    and the eval forward of the pre-step weights ride one exchange and one
    aggregation per layer; one all-reduce carries the gradient and the four
    metric sums; then Adam. Returns the row over all ranks on the device."""
    model = state.model
    model.zero_grad(set_to_none=True)
    lt, le = _forward_pair(model, inputs, cfg.dropout, state.generator, cfg.halo_dtype)
    ce_t, cor_t = _local_metrics(lt, truth_train.rows)
    with torch.no_grad():
        ce_e, cor_e = _local_metrics(le, truth_val.rows)
    (ce_t / truth_train.count).backward()
    l2 = l2_penalty(model.w1, cfg.weight_decay).detach()
    s = _reduce_step(model, [ce_t.detach(), cor_t, ce_e, cor_e], cfg.weight_decay)
    _adam_step(state, cfg.learning_rate)
    return torch.stack([s[0] / truth_train.count + l2, s[1] / truth_train.count,
                        s[2] / truth_val.count + l2, s[3] / truth_val.count])


def _es_epoch(state, inputs: ShardedInputs, truth_train: ShardedTruth,
              truth_val: ShardedTruth, cfg: GCNConfig) -> torch.Tensor:
    """One train step and the eval of the new weights (:516-566): their row."""
    tl, ta = train_step(state, inputs, truth_train, cfg)
    vl, va = eval_step(state.model, inputs, truth_val, cfg)
    return torch.stack([tl, ta, vl, va])


def run_epochs(state, inputs: ShardedInputs, truth_train: ShardedTruth,
               truth_val: ShardedTruth, cfg: GCNConfig, epochs: int) -> torch.Tensor:
    """``epochs`` pass-fused iterations launched from Python (:446-486).
    Returns [epochs, 4] = (train_loss, train_acc, val_loss, val_acc) on the
    device, realigned as train.run_epochs does."""
    rows = [_fused_epoch(state, inputs, truth_train, truth_val, cfg) for _ in range(epochs)]
    if not rows:
        return torch.zeros(0, 4, device=truth_train.rows.device)
    vl_last, va_last = eval_step(state.model, inputs, truth_val, cfg)
    m = torch.stack(rows)
    return torch.stack([m[:, 0], m[:, 1], torch.cat([m[1:, 2], vl_last[None]]),
                        torch.cat([m[1:, 3], va_last[None]])], dim=1)


def run_epochs_es(state, inputs: ShardedInputs, truth_train: ShardedTruth,
                  truth_val: ShardedTruth, cfg: GCNConfig, epochs: int, es_window: int):
    """Up to ``epochs`` (train step + eval) iterations with the reference's
    early stopping (:516-566, gcn.cpp:142-150), launched from Python: no pass
    fusion, one host read per epoch; every rank reads the same all-reduced
    loss, so all stop together. Returns (metrics [epochs run, 4] on the
    device, stopped)."""
    ring = torch.full((es_window,), float("inf"), device=truth_train.rows.device)
    rows, stopped = [], False
    for i in range(epochs):
        rows.append(_es_epoch(state, inputs, truth_train, truth_val, cfg))
        vl = rows[-1][2]
        epoch = i + 1
        ring[(epoch - 1) % es_window] = vl
        if epoch >= es_window and bool(vl > ring.mean()):
            stopped = True
            break
    if not rows:
        return torch.zeros(0, 4, device=truth_train.rows.device), stopped
    return torch.stack(rows), stopped


def _graphed(device: torch.device) -> bool:
    """An epoch is captured on the card unless the group is gloo's, whose
    host-staged exchange and all-reduce cannot be captured."""
    return device.type == "cuda" and (not dist.is_initialized()
                                      or dist.get_backend() == "nccl")


def run_epochs_chunked(state, inputs: ShardedInputs, truth_train: ShardedTruth,
                       truth_val: ShardedTruth, cfg: GCNConfig, epochs: int,
                       chunk: int | None = None, times_out: list | None = None):
    """``run_epochs`` in chunks (:489-515), through train.py's chunked loop:
    a CUDA graph of the rank's pass-fused epoch under NCCL, eager under gloo.
    Returns the same [epochs, 4] metrics as ``run_epochs``."""
    from cuda_gcn_torch import kernels, train

    return train.chunked_fused_epochs(
        lambda: _fused_epoch(state, inputs, truth_train, truth_val, cfg),
        lambda: eval_step(state.model, inputs, truth_val, cfg), state, inputs.edge_capacity,
        epochs=epochs, chunk=chunk, times_out=times_out,
        graphed=_graphed(truth_train.rows.device),
        counters=(kernels.launches, inputs.exchange.sent))


def run_epochs_es_chunked(state, inputs: ShardedInputs, truth_train: ShardedTruth,
                          truth_val: ShardedTruth, cfg: GCNConfig, epochs: int,
                          es_window: int, chunk: int | None = None,
                          times_out: list | None = None):
    """``run_epochs_es`` in chunks (:569-600), through train.py's chunked
    loop: a CUDA graph of the rank's early-stopping epoch under NCCL, whose
    stop flag (all-reduced, so the same on every rank) each rank reads after
    every epoch; eager under gloo. Returns (metrics [epochs run, 4],
    stopped)."""
    from cuda_gcn_torch import kernels, train

    return train.chunked_es_epochs(
        lambda: _es_epoch(state, inputs, truth_train, truth_val, cfg), state,
        inputs.edge_capacity, epochs=epochs, es_window=es_window, chunk=chunk,
        times_out=times_out, graphed=_graphed(truth_train.rows.device),
        counters=(kernels.launches, inputs.exchange.sent))


@dataclasses.dataclass
class HostShard:
    """One rank's share of a prepared dataset, on the host (picklable, so
    that a launcher can hand it to the rank's process)."""

    part: PartView
    x: object                   # [block, F] float32 slab, or (indptr, indices, values) rows
    n_cols: int
    truths: dict                # split -> [block] int64, -1 on padding rows
    counts: dict                # split -> node count over all parts

    @property
    def boundary_edges(self) -> int:
        return len(self.part.boundary[0])


def prepare_sharded(cfg: GCNConfig, dataset: GCNDataset, n_parts: int,
                    lpa_labels: np.ndarray | None = None, **partition_kwargs):
    """Partition a dataset into ``n_parts`` shards on the host (:611-677).
    Returns (cfg, [HostShard] by rank, the PartitionedGraph).

    Unless ``cfg.reorder`` is 'none' the dataset is first relabelled by
    ``reorder.partition_layout`` over its LPA labels and cut at its part
    boundaries; ``lpa_labels``, the labels of this dataset's node order
    (computed or cached by the caller), skip the label propagation. A
    caller that relabels the dataset itself passes 'none' and the ``cuts``.
    The interiors take dense tiles on the bsr backend, and on
    'auto' above ``DENSE_BACKEND_MAX_NODES`` nodes a part.
    ``partition_kwargs`` go to ``partition_graph`` (cuts, tile size, budget,
    ``device``)."""
    cfg = dataset.apply_config(cfg)
    if cfg.reorder != "none":
        from cuda_gcn_torch.data.reorder import label_propagation, partition_layout

        labels = (lpa_labels if lpa_labels is not None else
                  label_propagation(dataset.graph.indptr, dataset.graph.indices))
        deg = np.diff(dataset.graph.indptr.astype(np.int64))
        perm, cuts = partition_layout(dataset.graph.indptr, dataset.graph.indices,
                                      labels, n_parts, weights=deg)
        dataset = reorder_dataset(dataset, perm)
        partition_kwargs.setdefault("cuts", cuts)
    block = -(-dataset.num_nodes // n_parts)
    interior_tiles = (cfg.graphsum_backend == "bsr"
                      or (cfg.graphsum_backend == "auto" and block > DENSE_BACKEND_MAX_NODES))
    pg = partition_graph(dataset.graph, n_parts, interior_tiles=interior_tiles,
                         **partition_kwargs)
    bounds = pg.bounds
    fi = dataset.feature_index
    x = None if cfg.feature_matmul == "sparse" else dataset.dense_features(np.float32)
    truths = {s: pg.pad_nodes(np.where(dataset.split == s, dataset.label, -1)
                              .astype(np.int64), fill=-1) for s in (1, 2, 3)}
    counts = {s: int((dataset.split == s).sum()) for s in (1, 2, 3)}
    shards = []
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if x is None:
            xp = slice_feature_rows(fi.indptr, fi.indices, dataset.feature_value, lo, hi,
                                    pg.block)
        else:
            xp = np.zeros((pg.block, dataset.input_dim), np.float32)
            xp[:hi - lo] = x[lo:hi]
        rows = slice(p * pg.block, (p + 1) * pg.block)
        shards.append(HostShard(part=pg.part(p), x=xp, n_cols=dataset.input_dim,
                                truths={s: t[rows] for s, t in truths.items()},
                                counts=counts))
    return cfg, shards, pg


def rank_generator(gen: torch.Generator, rank: int) -> torch.Generator:
    """Move ``gen`` to rank ``rank``'s dropout stream: its seed plus rank ×
    ``RANK_SEED_STRIDE`` (mod 2^32), its Philox offset kept (the ranks draw
    the same counts: every slab is ``block`` rows). Rank 0 keeps the
    single-device stream."""
    if rank:
        offset = gen.get_offset() if gen.device.type == "cuda" else None
        gen.manual_seed((gen.initial_seed() + rank * RANK_SEED_STRIDE) % (1 << 32))
        if offset is not None:
            gen.set_offset(offset)
    return gen


def shard_inputs(cfg: GCNConfig, shard: HostShard, device):
    """This rank's ShardedInputs and truths on ``device`` from its HostShard.
    The exchange stages its payloads through host memory exactly when they
    lie on a card and the default group is gloo's."""
    device = torch.device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != shard.part.n_parts or rank != shard.part.rank:
        raise ValueError(f"rank {rank} of {world} was given part {shard.part.rank} of "
                         f"{shard.part.n_parts}")
    act = getattr(torch, cfg.compute_dtype)
    if device.type == "cuda":
        from cuda_gcn_torch import kernels

        kernels.build()
    x, block = shard.x, shard.part.block
    if isinstance(x, tuple):  # the part's CSR rows, already re-based and padded
        x = make_sparse_features_parts(*x, [0, block], block, shard.n_cols, act, device)[0]
    stage_host = device.type == "cuda" and world > 1 and dist.get_backend() == "gloo"
    ex = HaloExchange(rank, world, shard.part.hmax_k, stage_host=stage_host)
    inputs = make_sharded_inputs(shard.part, x, device, ex, act)
    truths = {s: ShardedTruth(torch.from_numpy(t).to(device), shard.counts[s])
              for s, t in shard.truths.items()}
    return inputs, truths


def create_state(cfg: GCNConfig, device, rank: int, initial_state=None):
    """train.create_state (or ``initial_state``) with rank ``rank``'s
    dropout stream."""
    from cuda_gcn_torch import train

    state = initial_state if initial_state is not None else train.create_state(cfg, device)
    rank_generator(state.generator, rank)
    return state


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sharded(cfg: GCNConfig, shard: HostShard, device=None, verbose: bool = True,
                initial_state=None):
    """This rank's part of a sharded training run (:680-757) in an
    initialized process group, with the reference's epoch loop, output lines
    (printed by rank 0) and early stopping, as train.run: more than one epoch
    through ``run_epochs_chunked`` or, with ``cfg.early_stopping``,
    ``run_epochs_es_chunked``; one epoch stepwise. ``initial_state`` restores
    a checkpoint (rank 0's dropout stream; each rank moves to its own).
    Returns train.RunResult on every rank."""
    from cuda_gcn_torch import train
    from cuda_gcn_torch.utils.timer import TMR_TEST, TMR_TRAIN, timers

    device = resolve_device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    verbose = verbose and rank == 0
    inputs, truths = shard_inputs(cfg, shard, device)
    timers.reset(TMR_TRAIN, TMR_TEST)
    state = create_state(cfg, device, rank, initial_state)
    stopped = False
    _sync(device)
    if cfg.epochs > 1:
        timers.start(TMR_TRAIN)
        times: list[float] = []
        if cfg.early_stopping > 0:
            metrics, stopped = run_epochs_es_chunked(state, inputs, truths[1], truths[2],
                                                     cfg, cfg.epochs, cfg.early_stopping,
                                                     times_out=times)
        else:
            metrics = run_epochs_chunked(state, inputs, truths[1], truths[2], cfg,
                                         cfg.epochs, times_out=times)
        timers.stop(TMR_TRAIN, sync=metrics)
        history = train.report_epochs(metrics.tolist(), times, verbose)
    else:
        history = []
        for _ in range(cfg.epochs):
            timers.start(TMR_TRAIN)
            row = _es_epoch(state, inputs, truths[1], truths[2], cfg).tolist()
            history += train.report_epochs([row], [timers.stop(TMR_TRAIN)], verbose)
    total = timers.total(TMR_TRAIN)
    if verbose:
        if stopped:
            print("Early stopping...")
        print(f"total training time={total:.5f}")
    timers.start(TMR_TEST)
    test_loss, test_acc = eval_step(state.model, inputs, truths[3], cfg)
    test_time = timers.stop(TMR_TEST, sync=test_loss)
    test_loss, test_acc = float(test_loss), float(test_acc)
    if verbose:
        print(f"test_loss={test_loss:.5f} test_acc={test_acc:.5f} time={test_time:.5f}")
    return train.RunResult(test_loss=test_loss, test_acc=test_acc, total_train_time=total,
                           epochs_run=len(history), state=state, history=history)

