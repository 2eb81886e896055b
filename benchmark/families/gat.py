"""The GAT family: Veličković et al.'s graph attention network
(arXiv:1710.10903) in its transductive configuration, trained full batch by
``cuda_gcn_torch`` (models/gat.py).

A configuration's ``model`` gives ``family`` 'gat', ``hidden_dims`` (the
features of one head of each hidden layer), ``heads`` (each layer's; the
hidden layers concatenate theirs, the output layer averages), ``dropout``
(both layers' inputs), ``attention_dropout``, ``leaky_slope``,
``learning_rate`` and ``weight_decay``; the traffic file a job's ``epochs``,
``early_stopping`` and ``feature_matmul``.

**The program's side** imports ``cuda_gcn_torch`` inside its functions only.
A job is the gcn family's (``run_job``: ``train.create_state`` for the job's
seed, ``train.run_epochs_chunked``, ``train.eval_step`` on the test split),
which builds the model ``GCNConfig.model`` names. ``check_steps`` reads back
every mask the program drew in the comparison's steps without drawing any
again: x's and the hidden layer's from the tensors the steps save for their
backward (the dropped x, the hidden dropout's kept mask), and each
attention's from the two int64 seeds its op saves, expanded here by a plain
Philox4x32-10 in the program's layout (ops/attention.py ``attention_keep``:
head k of forward slot s is word k % 4 of the call at counter s·⌈K/4⌉ + k/4,
kept below q·2^32), put in the order of the graph's CSR through the
program's ELL plan.

**The reference** (``reference_inputs``, ``follow``) imports nothing of the
program and nothing of JAX: plain float32 PyTorch with TF32 off
(``reference.use_float32``), an edge-list forward over Â's pattern in CSR
order (``index_select`` / ``index_add_``, the [E, K, F'] terms in blocks of
edges), the masked cross-entropy plus wd/2 · every parameter's squared norm,
autograd's gradients and the reference program's Adam (``reference.
adam_step``). The weights are Glorot from the job's seed, drawn in the
program's order (w1, att_l1, att_r1, w2, ...; an attention vector [K, F'] as
a matrix of that shape). Departures from the paper, each where the program
departs too: no biases; the L2 term over every parameter; the neighbourhood
is the row of Â's pattern, whose self-loop the graph holds; dropout masks
are data (the program's).

**The compared numbers** (``NUMBERS``): ``loss_gap`` over each step's
training loss, the validation loss after it and the test loss;
``grad1_gap``, ``grad1_diff`` of the output layer's weight's first gradient
(as the gcn family's); ``grad1_att_gap``, ``grad1_att_diff`` of the attention
vectors' first gradients, all four as one vector; ``grad1_l0_gap``,
``grad1_l0_diff`` of layer 0's weight's; ``change_gap`` leaf by leaf; and
``mask_z``: the masks against independent draws at the configuration's
rates, in binomial standard deviations, over each step's kept share of X's
nonzeros, of the hidden layer's entries and of each layer's edge-
heads, and over the share on which two consecutive steps' masks agree.

**Faults** (``FAULTS``) planted in the reference: ``state_unchanged``,
``half_batch``, ``attention_dropout_skipped`` (α kept whole),
``softmax_over_sources`` (α normalised over the edges into each source
instead of each row), ``self_loops_dropped``, ``leaky_slope_0.1``,
``heads_averaged`` (the hidden layer's heads replaced by their mean instead
of concatenated), ``attention_dropout_rate`` (attention masks of the
reference's own, drawn at p + 0.05: what ``mask_z`` reads of a mask drawn at
another rate). ``CONTROL``: TF32-rounded dense products.

**The roofline** (``job_work``) from shapes alone: an attention pass reads
the columns (4 bytes a slot), the row pointers, z and the two scores once
and writes its output once, with 2·F' + 4 operations an edge-head (the
weighted sum, the score, its LeakyReLU, exp and sum); its backward reads the
columns, the row pointers, g, z and the scores and writes dz and both score
gradients, with 4·F' + 8 an edge-head; no [S, K] tensor is counted. A fixed-
length epoch is the fused pair: each layer's training and evaluation
forward and its backward; an early-stopping epoch the training forward and
backward and the evaluation's forward. Layer 0 on dense x reads x once for
the pair and once for dW (2·N·F·H operations a product), on sparse x its
values and indices; the later layers' dense products are not counted. Parts:
'attention', 'layer0', 'total'.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import compare, program, reference
from benchmark.families.gcn import Prepared, _train, run_job  # noqa: F401 (run_job: the API's)
from benchmark.roofline import INDEX_BYTES, ITEMSIZE, Work

NUMBERS = ("loss_gap", "grad1_gap", "grad1_diff", "grad1_att_gap", "grad1_att_diff",
           "grad1_l0_gap", "grad1_l0_diff", "change_gap", "mask_z")
FAULTS = ("state_unchanged", "half_batch", "attention_dropout_skipped", "softmax_over_sources",
          "self_loops_dropped", "leaky_slope_0.1", "heads_averaged", "attention_dropout_rate")
CONTROL = "tf32"
STEPS = 3  # one epoch, then two from its state (an eager epoch, a capture and its replay)
RATE_FAULT = 0.05  # 'attention_dropout_rate' drops this much more than the configuration's rate
EDGE_BLOCK = 1 << 22  # edges a block of the reference's [E, K, F'] terms
_U32 = 0xFFFFFFFF


def hidden_dims(model: dict) -> tuple[int, ...]:
    return tuple(model["hidden_dims"]) if "hidden_dims" in model else (model["hidden_dim"],)


def heads_of(model: dict) -> tuple[int, ...]:
    return tuple(int(k) for k in model["heads"])


@dataclasses.dataclass
class Readings:
    """What a job's first steps give, on either side of the comparison."""

    train_loss: list[float]
    val_loss: list[float]
    test_loss: float
    grad1: list[torch.Tensor]   # the first step's gradient, a tensor a parameter
    change: list[torch.Tensor]  # final parameters less initial ones
    # each step's kept masks: X's nnz in CSR order, the hidden layers [N, width],
    # then each layer's attention [E, K] in the graph's CSR order
    masks: list[tuple[torch.Tensor, ...]] | None = None
    # the reference's side: where X's mask shows (its nonzeros; every hidden
    # entry and edge-head shows), the layers, and the kept shares
    x_nonzero: torch.Tensor | None = None
    layers: int = 0
    keep: float = 1.0
    att_keep: float = 1.0


# ---- the program's side --------------------------------------------------

def prepare(config: dict, traffic: dict, data: dict, device: str = "cuda") -> Prepared:
    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig

    model = config["model"]
    cfg = GCNConfig(model="gat", hidden_dims=hidden_dims(model), heads=heads_of(model),
                    dropout=model["dropout"], attention_dropout=model["attention_dropout"],
                    leaky_slope=model["leaky_slope"], learning_rate=model["learning_rate"],
                    weight_decay=model["weight_decay"], epochs=traffic["epochs"],
                    early_stopping=traffic["early_stopping"],
                    graphsum_backend=config["graphsum_backend"],
                    compute_dtype=config["compute_dtype"], param_dtype=config["param_dtype"],
                    feature_matmul=traffic["feature_matmul"])
    cfg, graph, x, truths = train.prepare(cfg, program.dataset_of(data), device)
    return Prepared(cfg=cfg, graph=graph, x=x, truths=truths, device=torch.device(device))


def philox(key: tuple[int, int], ctr: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Salmon et al., SC'11) in int64 tensor operations:
    ``ctr`` [..., 4] of 32-bit words under ``key`` -> [..., 4]."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for _ in range(10):
        p0, p1 = c0 * 0xD2511F53, c2 * 0xCD9E8D57
        c0, c1, c2, c3 = (((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32,
                          ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32)
        k0, k1 = (k0 + 0x9E3779B9) & _U32, (k1 + 0xBB67AE85) & _U32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def keep_threshold(rate: float) -> tuple[float, int]:
    """(q, the threshold below which a 32-bit word keeps its weight): q = 1 - p
    in float32, the threshold q·2^32 rounded."""
    q = float(np.float32(1.0 - rate))
    return q, min(round(q * 2.0**32), 2**32 - 1)


def expand_mask(seeds, slots: torch.Tensor, heads: int, rate: float) -> torch.Tensor:
    """The attention masks [len(slots), K] (bool, on the host) that the
    program's seeds give its forward slots ``slots``."""
    seed, offset = (int(v) % 2**64 for v in seeds)
    thresh = keep_threshold(rate)[1]
    calls = -(-heads // 4)
    out = []
    for a in range(0, len(slots), EDGE_BLOCK):
        c = (slots[a:a + EDGE_BLOCK, None] * calls
             + torch.arange(calls, device=slots.device)).reshape(-1)
        ctr = torch.stack([c & _U32, c >> 32, torch.full_like(c, offset & _U32),
                           torch.full_like(c, offset >> 32)], dim=-1)
        u = philox((seed & _U32, seed >> 32), ctr).reshape(-1, calls * 4)[:, :heads]
        out.append((u < thresh).cpu())
    return torch.cat(out) if out else torch.zeros(0, heads, dtype=torch.bool)


def csr_slots(p: Prepared, data: dict) -> torch.Tensor:
    """The program's forward slot of each edge of the graph's CSR, in CSR
    order (int64, on the program's device), from its ELL plan."""
    from cuda_gcn_torch.ops.ell import slot_edges

    slot, row, col = slot_edges(p.graph.edge_map.plan)
    n = int(data["num_nodes"])
    indptr = torch.from_numpy(data["indptr"].astype(np.int64)).to(slot.device)
    r = torch.repeat_interleave(torch.arange(n, device=slot.device), indptr[1:] - indptr[:-1])
    key_csr = r * n + torch.from_numpy(data["indices"].astype(np.int64)).to(slot.device)
    del r
    key_p, order_p = torch.sort(row * n + col, stable=True)
    key_c, order_c = torch.sort(key_csr, stable=True)
    if not torch.equal(key_p, key_c):
        raise ValueError("the program's ELL plan does not hold the graph's edges")
    del key_p, key_c, row, col
    out = torch.empty_like(slot)
    out[order_c] = slot[order_p]
    return out


class _MaskReader:
    """Reads a training step's masks back from the tensors its forward saves
    for the backward pass (``torch.autograd.graph.saved_tensors_hooks``):
    the layer-0 product's dropped operand (a float tensor of X's shape: [N, F]
    dense, or X's nnz values) opens a step, kept where it is not 0 at X's nnz;
    the hidden dropout's kept mask (a bool [N, width]); each attention's two
    int64 seeds, layer by layer. A mask read during a CUDA graph's capture
    holds the values of the graph's replays, so the masks are expanded after
    the call."""

    def __init__(self, p: Prepared, data: dict):
        x = p.x
        self.dense = isinstance(x, torch.Tensor)
        if self.dense:
            f_indptr = data["f_indptr"].astype(np.int64)
            rows = np.repeat(np.arange(len(f_indptr) - 1, dtype=np.int64), np.diff(f_indptr))
            self.at = torch.from_numpy(rows * x.shape[1] + data["f_indices"]).to(x.device)
        self.x_shapes = {tuple(x.shape)} if self.dense else {(x.nnz,), (x.nnz, 1)}
        n = int(data["num_nodes"])
        dims, heads = p.cfg.layer_dims(), p.cfg.layer_heads()
        self.hidden_shapes = {(n, k * w) for k, w in zip(heads[:-1], dims[1:-1])}
        self.steps: list[list] = []

    def pack(self, t: torch.Tensor):
        shape = tuple(t.shape)
        if t.is_floating_point() and shape in self.x_shapes:
            flat = t.reshape(-1)
            self.steps.append([(flat[self.at] if self.dense else flat) != 0, [], []])
        elif t.dtype == torch.bool and shape in self.hidden_shapes and self.steps:
            self.steps[-1][1].append(t)
        elif t.dtype == torch.int64 and shape == (2,) and self.steps:
            self.steps[-1][2].append(t)
        return t

    def masks(self, p: Prepared, data: dict) -> list[tuple[torch.Tensor, ...]]:
        """Each step's (X's kept nnz, the hidden layers' kept masks, each
        layer's attention mask in CSR order), on the host."""
        slots = csr_slots(p, data)
        heads, rate = p.cfg.layer_heads(), p.cfg.attention_dropout
        out = []
        for x_kept, hidden, seeds in self.steps:
            att = [expand_mask(s.tolist(), slots, k, rate) for s, k in zip(seeds, heads)]
            out.append((x_kept.cpu(), *(h.cpu() for h in hidden), *att))
        return out


def check_steps(p: Prepared, data: dict, seed: int) -> Readings:
    """The first three steps of a job of ``seed`` through the window's own
    calls (one epoch, then two more from its state: an eager epoch, and a
    CUDA graph's capture and replay), and the test evaluation. The first
    gradient is read from Adam's first moment after one step; every mask
    is read back (``_MaskReader``)."""
    from cuda_gcn_torch import train
    from cuda_gcn_torch.ops.adam import AdamParams

    state = train.create_state(dataclasses.replace(p.cfg, seed=seed), p.device)
    names = [n for n, _ in state.model.named_parameters()]
    w0 = [w.detach().float().cpu().clone() for w in state.model.parameters()]
    reader = _MaskReader(p, data)
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        first = _train(p, state, 1, p.cfg.dropout).cpu().numpy()
        grad1 = [state.opt.m[n].detach().cpu() / (1.0 - AdamParams().beta1) for n in names]
        rest = _train(p, state, 2, p.cfg.dropout).cpu().numpy()
    test_loss, _ = train.eval_step(state.model, p.graph, p.x, p.truths[3],
                                   weight_decay=p.cfg.weight_decay)
    rows = np.concatenate([first, rest])
    change = [w.detach().float().cpu() - a for w, a in zip(state.model.parameters(), w0)]
    masks = reader.masks(p, data)
    return Readings(train_loss=[float(v) for v in rows[:, 0]],
                    val_loss=[float(v) for v in rows[:, 2]], test_loss=float(test_loss),
                    grad1=grad1, change=change, masks=masks)


# ---- the reference -------------------------------------------------------

@dataclasses.dataclass
class Problem:
    """The inputs of a job as the reference holds them, on ``device``."""

    n: int
    dst: torch.Tensor       # (E,) int64: Â's pattern in CSR order, self-loops included
    src: torch.Tensor
    x: torch.Tensor         # dense [N, F], or sparse CSR [N, F]
    f_rows: torch.Tensor    # X's nnz in CSR order
    f_cols: torch.Tensor
    f_values: torch.Tensor
    x_nonzero: torch.Tensor
    sparse: bool
    truth: dict[int, torch.Tensor]
    dims: tuple[int, ...]   # (F, F1', ..., C)
    heads: tuple[int, ...]

    def features(self, values: torch.Tensor) -> torch.Tensor:
        """X with ``values`` at its nnz (CSR order): sparse CSR, or dense."""
        if self.sparse:
            return reference.csr_t(self.x.crow_indices(), self.f_cols, values,
                                   (self.n, self.dims[0]))
        dense = torch.zeros(self.n, self.dims[0], device=values.device)
        dense[self.f_rows, self.f_cols] = values
        return dense


def reference_inputs(data: dict, config: dict, traffic: dict, device) -> Problem:
    """The reference's inputs from the generated arrays, built once a run."""
    n, f = int(data["num_nodes"]), int(data["input_dim"])
    indptr = data["indptr"].astype(np.int64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    f_indptr = data["f_indptr"].astype(np.int64)
    f_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(f_indptr))
    f_values = data["f_values"].astype(np.float32)
    label, split = data["label"], data["split"]
    model = config["model"]
    prob = Problem(n=n, dst=dev(dst), src=dev(data["indices"].astype(np.int64)),
                   x=reference.csr(f_indptr, data["f_indices"], f_values, (n, f), device),
                   f_rows=dev(f_rows), f_cols=dev(data["f_indices"].astype(np.int64)),
                   f_values=dev(f_values), x_nonzero=dev(f_values != 0),
                   sparse=traffic["feature_matmul"] == "sparse",
                   truth={s: dev(np.where(split == s, label, -1).astype(np.int64))
                          for s in (1, 2, 3)},
                   dims=(f, *hidden_dims(model), int(data["output_dim"])), heads=heads_of(model))
    if not prob.sparse:
        prob.x = prob.features(prob.f_values)
    return prob


def glorot_params(dims: tuple[int, ...], heads: tuple[int, ...], seed: int) -> dict:
    """{w1, att_l1, att_r1, w2, ...}: Glorot from one CPU generator seeded with
    ``seed``, in that order."""
    gen = torch.Generator().manual_seed(seed)
    params, fan_in = {}, dims[0]
    for i, k in enumerate(heads):
        for name, shape in ((f"w{i + 1}", (fan_in, k * dims[i + 1])),
                            (f"att_l{i + 1}", (k, dims[i + 1])),
                            (f"att_r{i + 1}", (k, dims[i + 1]))):
            a = (6.0 / sum(shape)) ** 0.5
            params[name] = torch.empty(*shape).uniform_(-a, a, generator=gen)
        fan_in = k * dims[i + 1]
    return params


def _matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b``; at 'tf32' a dense product's operands rounded to TF32
    (``reference.round_tf32``), the rounding passed over by the gradient."""
    if precision == "tf32" and a.layout != torch.sparse_csr:
        a = a + (reference.round_tf32(a.detach()) - a).detach()
        b = b + (reference.round_tf32(b.detach()) - b).detach()
    return a @ b


@dataclasses.dataclass
class Model:
    """The GAT's forward and loss as the reference runs them, with a fault
    planted where ``fault`` names one."""

    prob: Problem
    weight_decay: float
    slope: float
    precision: str = "float32"
    fault: str | None = None

    def __post_init__(self):
        p = self.prob
        dst, src = p.dst, p.src
        self.edges_kept = None  # the edges left, where the fault drops some
        if self.fault == "self_loops_dropped":
            self.edges_kept = dst != src
            dst, src = dst[self.edges_kept], src[self.edges_kept]
        self.dst, self.src = dst, src
        if self.fault == "leaky_slope_0.1":
            self.slope = 0.1

    def attention(self, z, a_l, a_r, heads, mask, keep):
        """One layer's h' [N, K·F'] (eqs. 1-4); the softmax over each row's
        edges (over each source's under 'softmax_over_sources')."""
        n = z.shape[0]
        dst, src = self.dst, self.src
        z3 = z.view(n, heads, -1)
        e = torch.nn.functional.leaky_relu((z3 * a_l).sum(-1).index_select(0, dst)
                                           + (z3 * a_r).sum(-1).index_select(0, src), self.slope)
        by = src if self.fault == "softmax_over_sources" else dst
        m = torch.full((n, heads), -math.inf, device=z.device).scatter_reduce(
            0, by[:, None].expand(-1, heads), e.detach(), "amax")
        w = torch.exp(e - m.index_select(0, by))
        den = torch.zeros(n, heads, device=z.device).index_add(0, by, w)
        alpha = w / den.index_select(0, by)
        if mask is not None:
            if self.edges_kept is not None:
                mask = mask[self.edges_kept]
            alpha = torch.where(mask, alpha / keep, torch.zeros((), device=z.device))
        out = torch.zeros_like(z3)
        for a in range(0, len(dst), EDGE_BLOCK):
            out = out.index_add(0, dst[a:a + EDGE_BLOCK],
                                alpha[a:a + EDGE_BLOCK, :, None]
                                * z3.index_select(0, src[a:a + EDGE_BLOCK]))
        return out.view(n, -1)

    def forward(self, params: dict, x, drop=None):
        """Logits; ``drop`` (X's kept values, hidden masks, attention masks,
        keep, attention keep) or None for the evaluation forward."""
        heads = self.prob.heads
        h = x
        for i, k in enumerate(heads):
            if i and drop is not None:
                h = torch.where(drop[1][i - 1], h / drop[3], torch.zeros((), device=h.device))
            z = _matmul(h, params[f"w{i + 1}"], self.precision)
            mask = None if drop is None else drop[2][i]
            h = self.attention(z, params[f"att_l{i + 1}"], params[f"att_r{i + 1}"], k, mask,
                               1.0 if drop is None else drop[4])
            if i < len(heads) - 1:
                h = torch.nn.functional.elu(h)
                if self.fault == "heads_averaged" and k > 1:
                    h = h.view(h.shape[0], k, -1).mean(1, keepdim=True).expand(
                        -1, k, -1).reshape(h.shape[0], -1)
            elif k > 1:
                h = h.view(h.shape[0], k, -1).mean(1)
        return h

    def loss(self, logits, truth, params):
        mask = truth >= 0
        ce = torch.nn.functional.cross_entropy(logits[mask], truth[mask], reduction="mean")
        return ce + 0.5 * self.weight_decay * sum(torch.sum(v * v) for v in params.values())


def train_steps(prob: Problem, params: dict, steps: int, lr: float, weight_decay: float,
                slope: float, rate: float, att_rate: float, precision: str = "float32",
                fault: str | None = None, masks=None) -> Readings:
    """``steps`` Adam steps from ``params``, step t's training forward with
    dropout by ``masks[t]`` (none where both rates are 0)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    reference.use_float32()
    device = prob.dst.device
    model = Model(prob, weight_decay, slope, precision, fault)
    truth = prob.truth[1]
    if fault == "half_batch":
        ids = torch.nonzero(truth >= 0)[:, 0]
        truth = truth.clone()
        truth[ids[len(ids) // 2:]] = -1
    n_hidden = len(prob.heads) - 1
    if fault == "attention_dropout_rate":
        gen = torch.Generator().manual_seed(int(masks[0][0].sum()))
        masks = [(*step[:1 + n_hidden],
                  *(torch.rand(m.shape, generator=gen) >= att_rate + RATE_FAULT
                    for m in step[1 + n_hidden:])) for step in masks]
    w = {k: v.to(device).clone() for k, v in params.items()}
    m = [torch.zeros_like(v) for v in w.values()]
    v = [torch.zeros_like(t) for t in w.values()]
    train_loss, val_loss, grad1 = [], [], []
    dropping = rate > 0 or att_rate > 0
    for t in range(1, steps + 1):
        drop = None
        if dropping:
            kept, *rest = (mask.to(device) for mask in masks[t - 1])
            hidden, att = rest[:n_hidden], rest[n_hidden:]
            if fault == "attention_dropout_skipped":
                att = [None] * len(att)
            values = torch.where(kept, prob.f_values / (1.0 - rate),
                                 torch.zeros((), device=device))
            drop = (prob.features(values), hidden, att, 1.0 - rate, 1.0 - att_rate)
        leaves = {k: t_.detach().clone().requires_grad_(True) for k, t_ in w.items()}
        loss = model.loss(model.forward(leaves, prob.x if drop is None else drop[0], drop),
                          truth, leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        train_loss.append(float(loss.detach()))
        del loss, leaves
        if t == 1:
            grad1 = [g.detach().clone() for g in grads]
        if fault != "state_unchanged":
            reference.adam_step(list(w.values()), m, v, list(grads), t, lr)
        del grads
        with torch.no_grad():
            val_loss.append(float(model.loss(model.forward(w, prob.x), prob.truth[2], w)))
    with torch.no_grad():
        test = float(model.loss(model.forward(w, prob.x), prob.truth[3], w))
    return Readings(train_loss=train_loss, val_loss=val_loss, test_loss=test,
                    grad1=[g.cpu() for g in grad1],
                    change=[(w[k].cpu() - params[k].cpu().float()) for k in params],
                    masks=masks if dropping else None, x_nonzero=prob.x_nonzero.cpu(),
                    layers=len(prob.heads), keep=1.0 - rate, att_keep=1.0 - att_rate)


def follow(prob: Problem, config: dict, seed: int, readings: Readings,
           precision: str = "float32", fault: str | None = None) -> Readings:
    """The reference over the comparison's steps of the job of ``seed`` with
    the program's masks from ``readings``."""
    model = config["model"]
    return train_steps(prob, glorot_params(prob.dims, prob.heads, seed), STEPS,
                       model["learning_rate"], model["weight_decay"], model["leaky_slope"],
                       model["dropout"], model["attention_dropout"], precision=precision,
                       fault=fault, masks=readings.masks)


# ---- the comparison ------------------------------------------------------

def mask_z(prog: Readings, ref: Readings) -> float:
    """``prog``'s masks against independent draws: X's nonzeros and the
    hidden layers' entries kept at 1 - p, each layer's edge-heads at the
    attention's 1 - p; and each mask against the previous step's."""
    if ref.keep >= 1.0 and ref.att_keep >= 1.0:
        return 0.0
    if prog.masks is None or len(prog.masks) != len(ref.train_loss):
        return math.inf
    kinds = ([(ref.keep, ref.x_nonzero)] + [(ref.keep, None)] * (ref.layers - 1)
             + [(ref.att_keep, None)] * ref.layers)
    zs, prev = [], None
    for step in prog.masks:
        if len(step) != len(kinds) or step[0].shape != ref.x_nonzero.shape:
            return math.inf
        for i, (m, (q, shown)) in enumerate(zip(step, kinds)):
            if q >= 1.0:
                continue
            if shown is None:
                zs.append(compare.z(int(m.sum()), m.numel(), q))
            else:
                zs.append(compare.z(int((m & shown).sum()), int(shown.sum()), q))
            if prev is not None:
                agree = q * q + (1.0 - q) ** 2
                same = prev[i] == m
                if shown is None:
                    zs.append(compare.z(int(same.sum()), m.numel(), agree))
                else:
                    zs.append(compare.z(int((same & shown).sum()), int(shown.sum()), agree))
        prev = step
    return compare.worst(zs)


def _att(grads: list[torch.Tensor], names: list[str]) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g, n in zip(grads, names) if n.startswith("att_")])


def numbers(prog: Readings, ref: Readings) -> dict[str, float]:
    """The compared numbers of ``prog`` judged against ``ref``."""
    names = _param_names(len(ref.grad1) // 3)
    out_gap, out_diff = compare.grad_numbers(prog.grad1[names.index(f"w{len(names) // 3}")],
                                             ref.grad1[names.index(f"w{len(names) // 3}")])
    att_gap, att_diff = compare.grad_numbers(_att(prog.grad1, names), _att(ref.grad1, names))
    l0_gap, l0_diff = compare.grad_numbers(prog.grad1[0], ref.grad1[0])
    return {"loss_gap": compare.loss_gap([*prog.train_loss, *prog.val_loss, prog.test_loss],
                                         [*ref.train_loss, *ref.val_loss, ref.test_loss]),
            "grad1_gap": out_gap, "grad1_diff": out_diff,
            "grad1_att_gap": att_gap, "grad1_att_diff": att_diff,
            "grad1_l0_gap": l0_gap, "grad1_l0_diff": l0_diff,
            "change_gap": compare.change_gap(prog.change, ref.change, ref.grad1),
            "mask_z": mask_z(prog, ref)}


def _param_names(layers: int) -> list[str]:
    return [f"{kind}{i + 1}" for i in range(layers) for kind in ("w", "att_l", "att_r")]


# ---- the roofline --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shapes:
    nodes: int
    nnz: int                 # Â's nnz, self-loops included
    feature_nnz: int
    dims: tuple[int, ...]    # (F, F1', ..., C)
    heads: tuple[int, ...]
    dtype: str = "float32"
    feature_matmul: str = "dense"


def _index(s: Shapes) -> float:
    return s.nnz * INDEX_BYTES + (s.nodes + 1) * INDEX_BYTES


def attention_pass(s: Shapes, layer: int) -> Work:
    """A layer's forward: columns, row pointers, z and both scores read once,
    out written once."""
    k, fh, item = s.heads[layer], s.dims[layer + 1], ITEMSIZE[s.dtype]
    return Work(bytes=_index(s) + 2 * s.nodes * k * fh * item + 2 * s.nodes * k * item,
                flops=s.nnz * k * (2.0 * fh + 4))


def attention_backward(s: Shapes, layer: int) -> Work:
    """A layer's backward: columns, row pointers, g, z and both scores read
    once, dz and both score gradients written once."""
    k, fh, item = s.heads[layer], s.dims[layer + 1], ITEMSIZE[s.dtype]
    return Work(bytes=_index(s) + 3 * s.nodes * k * fh * item + 4 * s.nodes * k * item,
                flops=s.nnz * k * (4.0 * fh + 8))


def layer0_read(s: Shapes) -> Work:
    f, h = s.dims[0], s.heads[0] * s.dims[1]
    item = ITEMSIZE[s.dtype]
    if s.feature_matmul == "sparse":
        return Work(bytes=s.feature_nnz * (item + INDEX_BYTES) + (s.nodes + 1) * INDEX_BYTES,
                    flops=2.0 * s.feature_nnz * h)
    return Work(bytes=s.nodes * f * item, flops=2.0 * s.nodes * f * h)


def _sum(works) -> Work:
    total = Work()
    for w in works:
        total = total + w
    return total


def epoch(s: Shapes, early_stopping: bool) -> dict[str, Work]:
    layers = range(len(s.heads))
    fwd = _sum(attention_pass(s, i) for i in layers)
    bwd = _sum(attention_backward(s, i) for i in layers)
    pair = layer0_read(s)
    if early_stopping:
        return {"attention": fwd * 2 + bwd, "layer0": layer0_read(s) * 3}
    return {"attention": fwd * 2 + bwd, "layer0": pair + Work(flops=pair.flops) + layer0_read(s)}


def evaluation(s: Shapes) -> dict[str, Work]:
    return {"attention": _sum(attention_pass(s, i) for i in range(len(s.heads))),
            "layer0": layer0_read(s)}


def shapes(prep: Prepared, data: dict, config: dict, traffic: dict) -> Shapes:
    return Shapes(nodes=int(data["num_nodes"]), nnz=len(data["indices"]),
                  feature_nnz=len(data["f_values"]), dims=tuple(prep.cfg.layer_dims()),
                  heads=tuple(prep.cfg.layer_heads()), dtype=config["compute_dtype"],
                  feature_matmul=traffic["feature_matmul"])


def job_work(s: Shapes, epochs: int, early_stopping: bool) -> dict[str, Work]:
    """{'attention', 'layer0', 'total'} of a job of ``epochs`` epochs: the
    epochs, the fixed-length loop's trailing evaluation and the test one."""
    per = epoch(s, early_stopping)
    ev = evaluation(s)
    n_evals = 1 if early_stopping else 2
    out = {k: per[k] * epochs + ev[k] * n_evals for k in per}
    out["total"] = out["attention"] + out["layer0"]
    return out
