"""The GCN family: Kipf & Welling's graph convolutional network
(arXiv:1609.02907) at any depth, trained full batch by ``cuda_gcn_torch``.

A configuration's ``model`` gives ``hidden_dims`` (a list; where absent, one
hidden layer of ``hidden_dim``), ``dropout``, ``learning_rate`` and
``weight_decay``; the traffic file a job's ``epochs``, ``early_stopping``
and ``feature_matmul`` ('dense' or 'sparse' layer-0 features).

**The program's side** imports ``cuda_gcn_torch`` inside its functions only.
A training job makes the calls ``train.run`` makes, without its printing:
``train.create_state`` for the job's seed, then ``train.run_epochs_chunked``
(``train.run_epochs_es_chunked`` with early stopping), then
``train.eval_step`` on the test split, its results read back by the host.

**The reference** (``reference_inputs``, ``follow``) imports nothing of the
program and takes nothing the program made but the dropout masks it drew.
From the generated arrays alone it works out the normalised adjacency
Â = D^-1/2 (A+I) D^-1/2 (the self-loop is already the first entry of each
row; D counts it), the Glorot initial weights from the job's seed, and every
step: forward, the masked softmax cross-entropy plus wd/2·||W1||², the
gradients written out by hand (no autograd), and Adam
(``reference.adam_step``). It keeps the nodes in the order generated, which
is the program's own on the cells' backend (ell relabels nothing), so the
masks read back line up with its rows. Dropout is data here: the program
draws its masks inside the timed path, and a reference that redrew the same
masks would tie the program to today's order of random draws (PERF.md). So
the reference takes each step's kept masks as the program drew them
(``check_steps`` reads them back) and applies them itself: kept values
scaled by 1/(1-p), as Kipf & Welling's inverted dropout does; ``mask_z``
judges the masks themselves apart.

**The compared numbers** (``NUMBERS``):

* ``loss_gap``: the largest relative gap over the losses the steps report
  (each step's training loss, the validation loss after it, the final test
  loss);
* ``grad1_gap``: the first gradient of the output layer (the last weight),
  the gap between the program's norm and the reference's over the
  reference's norm;
* ``change_gap``: the weights' change over the steps, leaf by leaf
  (``compare.change_gap``);
* ``grad1_diff``: the first gradient of the output layer, the norm of the
  difference over the reference's norm;
* ``grad1_l0_gap``, ``grad1_l0_diff``: the same two of the first layer's
  first gradient (the layer-0 product's dW). Adam's first steps move a
  weight by about lr·sign(g), so ``change_gap`` hardly sees a gradient off
  by a factor: these do;
* ``mask_z``: the program's dropout masks against independent draws at the
  configuration's rate, in binomial standard deviations, the largest over
  each step's kept share of X's nonzeros and of each hidden layer's positive
  entries, and over the share of those on which two consecutive steps'
  masks agree. A dropout left out reads the square root of the count
  (thousands at reddit's size), a mask drawn once and replayed reads as far.

The first layer's gradient passes the ReLU's derivative, and where a
pre-activation lies within float32 rounding of 0 rounding flips its term:
its numbers read up to 40x a seed's usual gap on a few seeds (PERF.md gives
the readings). ``grad1_diff`` is there because the norms average a
product's rounding over many terms: they read the TF32 control within 3x of
float32's own rounding on reddit, and the difference does not average it
away.

**The roofline** (``job_work``) reads the node count, the adjacency's nnz
(self-loops included), the feature matrix's nnz, the layer widths and the
activations' type. Each input is read once and each output written once a
pass:

* an adjacency pass at width d: its column indices (4 bytes an nnz) and row
  pointers (4 bytes a node), h read and out written (N·d each, in the
  activations' type); 2·nnz·d operations. The coefficients are not counted:
  they follow from the row lengths;
* layer 0 on dense x: x read once for the forward product (the training and
  the evaluation halves of a fused pass share the read) and once for dW, with
  2·N·F·H operations a product (H the first hidden width); on sparse x: its
  values and column indices (activation type + 4 bytes an nnz) and row
  pointers instead of x, 2·nnz·H operations a product; the products' outputs
  are not counted, nor the later layers' dense products (N·H·C operations,
  small beside the passes).

A fixed-length epoch is the fused pair (the training forward and the
evaluation of the weights before the step in the same passes): forward at
twice each layer's width, backward at each width from the last, x read
twice. An early-stopping epoch evaluates after the step: forward, backward,
and the evaluation's forward, x read three times. A job adds its evaluations
(the fused loop's trailing one and the test one): forward, x once.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import compare, program, reference
from benchmark.roofline import INDEX_BYTES, ITEMSIZE, Work

NUMBERS = ("loss_gap", "grad1_gap", "change_gap", "grad1_diff", "grad1_l0_gap",
           "grad1_l0_diff", "mask_z")
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "dropout_skipped",
          "hidden_dropout_skipped", "dropout_unscaled", "dropout_rate", "grad0_scaled")
CONTROL = "tf32"
STEPS = 3  # the comparison's steps: one epoch, then two from its state
RATE_FAULT = 0.05  # 'dropout_rate' drops this much more than the configuration's rate


def hidden_dims(model: dict) -> tuple[int, ...]:
    """The hidden layers' widths: ``hidden_dims``, else one layer of ``hidden_dim``."""
    return tuple(model["hidden_dims"]) if "hidden_dims" in model else (model["hidden_dim"],)


@dataclasses.dataclass
class Readings:
    """What a job's first steps give, on either side of the comparison."""

    train_loss: list[float]   # step i's loss at the weights before it
    val_loss: list[float]     # the validation loss of the weights after step i
    test_loss: float          # the test loss of the final weights
    grad1: list[torch.Tensor]  # the first step's gradient, a tensor a leaf
    change: list[torch.Tensor]  # final weights less initial ones, a leaf each
    # each step's kept masks: X's nnz in CSR order, then each hidden layer
    # [N, H] (bool, kept where True), as the program drew them or as the
    # reference applied them
    masks: list[tuple[torch.Tensor, ...]] | None = None
    # the reference's side: each step's hidden layers > 0 (where a hidden mask
    # shows), X's nnz that are not 0, and the kept share 1-p
    active: list[tuple[torch.Tensor, ...]] | None = None
    x_nonzero: torch.Tensor | None = None
    keep: float = 1.0


# ---- the program's side --------------------------------------------------

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
    cfg = GCNConfig(hidden_dims=hidden_dims(model), dropout=model["dropout"],
                    learning_rate=model["learning_rate"],
                    weight_decay=model["weight_decay"], epochs=traffic["epochs"],
                    early_stopping=traffic["early_stopping"],
                    graphsum_backend=config["graphsum_backend"],
                    compute_dtype=config["compute_dtype"],
                    param_dtype=config["param_dtype"],
                    feature_matmul=traffic["feature_matmul"])
    cfg, graph, x, truths = train.prepare(cfg, program.dataset_of(data), device)
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
    not 0, read at X's nnz. Each hidden layer saves its ReLU's result and
    then the dropped operand of the next layer's product, whose nonzeros lie
    among the ReLU's; so the step's [N, H] float tensors fall into one group
    a layer, each opened by a tensor whose nonzeros do not lie among the
    previous one's, and the layer's kept mask is where the tensor of its
    group with the fewest nonzeros is not 0. A mask read during a CUDA
    graph's capture holds the values of the graph's replays, so the groups
    are formed after the call."""

    def __init__(self, p: Prepared, data: dict):
        x = p.x
        self.dense = isinstance(x, torch.Tensor)
        if self.dense:  # X's nnz in CSR order, as positions in the flat dense X
            f_indptr = data["f_indptr"].astype(np.int64)
            rows = np.repeat(np.arange(len(f_indptr) - 1, dtype=np.int64), np.diff(f_indptr))
            self.at = torch.from_numpy(rows * x.shape[1] + data["f_indices"]).to(x.device)
        self.x_shapes = {tuple(x.shape)} if self.dense else {(x.nnz,), (x.nnz, 1)}
        n, widths = int(data["num_nodes"]), p.cfg.layer_dims()[1:-1]
        self.hidden_shapes = {(n, w) for w in widths}
        self.hidden_layers = len(widths)
        self.steps: list[list] = []

    def pack(self, t: torch.Tensor):
        if t.is_floating_point():
            shape = tuple(t.shape)
            if shape in self.x_shapes:
                flat = t.reshape(-1)
                self.steps.append([(flat[self.at] if self.dense else flat) != 0, []])
            elif shape in self.hidden_shapes and self.steps:
                self.steps[-1][1].append(t != 0)
        return t

    def masks(self) -> list[tuple[torch.Tensor, ...]]:
        """Each step's (X's kept nnz, each hidden layer's kept mask), on the
        host; a hidden layer with no candidate keeps an empty mask."""
        out = []
        for x_kept, candidates in self.steps:
            groups: list[list[torch.Tensor]] = []
            for m in candidates:
                prev = groups[-1][-1] if groups else None
                if prev is not None and m.shape == prev.shape and not bool((m & ~prev).any()):
                    groups[-1].append(m)
                else:
                    groups.append([m])
            hidden = [min(g, key=lambda m: int(m.sum())).cpu() for g in groups]
            hidden += [torch.zeros(0, dtype=bool)] * (self.hidden_layers - len(hidden))
            out.append((x_kept.cpu(), *hidden))
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


# ---- the reference -------------------------------------------------------

@dataclasses.dataclass
class Problem:
    """The inputs of a job as the reference holds them, on ``device``."""

    adj: torch.Tensor       # Â, sparse CSR [N, N]
    adj_t: torch.Tensor     # Âᵀ, sparse CSR
    x: torch.Tensor         # dense [N, F], or sparse CSR [N, F]
    f_rows: torch.Tensor    # X's nnz in CSR order: row, column, value
    f_cols: torch.Tensor
    f_values: torch.Tensor
    x_nonzero: torch.Tensor  # bool, X's nnz whose value is not 0 (where a mask shows)
    t_perm: torch.Tensor    # Xᵀ's nnz in its CSR order, as positions in X's
    t_crow: torch.Tensor    # Xᵀ's row pointer and columns
    t_cols: torch.Tensor
    sparse: bool
    truth: dict[int, torch.Tensor]  # split code -> label where the split matches, else -1
    dims: tuple[int, ...]

    def features(self, values: torch.Tensor):
        """(X, Xᵀ) with ``values`` at X's nnz (in CSR order): sparse CSR both,
        or a dense X and None."""
        n, f = self.truth[1].shape[0], self.dims[0]
        if self.sparse:
            return (reference.csr_t(self.x.crow_indices(), self.f_cols, values, (n, f)),
                    reference.csr_t(self.t_crow, self.t_cols, values[self.t_perm], (f, n)))
        dense = torch.zeros(n, f, device=values.device)
        dense[self.f_rows, self.f_cols] = values
        return dense, None


def build_problem(data: dict, hidden: tuple[int, ...], feature_matmul: str,
                  device) -> Problem:
    """The reference's inputs from the generated arrays (synth.make_synthetic)."""
    n, f = int(data["num_nodes"]), int(data["input_dim"])
    indptr = data["indptr"].astype(np.int64)
    indices = data["indices"].astype(np.int64)
    deg = np.diff(indptr).astype(np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    coef = (1.0 / np.sqrt(deg[rows] * deg[indices])).astype(np.float32)
    adj = reference.csr(indptr, indices, coef, (n, n), device)
    adj_t = reference.csr(*reference.transpose_csr(indptr, indices, coef, n), (n, n), device)
    f_indptr = data["f_indptr"].astype(np.int64)
    f_indices = data["f_indices"].astype(np.int64)
    f_values = data["f_values"].astype(np.float32)
    f_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(f_indptr))
    t_crow, _, t_perm = reference.transpose_csr(f_indptr, f_indices,
                                                np.arange(len(f_indices)), f)
    x = reference.csr(f_indptr, f_indices, f_values, (n, f), device)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    label, split = data["label"], data["split"]
    truth = {s: dev(np.where(split == s, label, -1).astype(np.int64)) for s in (1, 2, 3)}
    prob = Problem(adj=adj, adj_t=adj_t, x=x, f_rows=dev(f_rows), f_cols=dev(f_indices),
                   f_values=dev(f_values), x_nonzero=dev(f_values != 0),
                   t_perm=dev(t_perm), t_crow=dev(t_crow), t_cols=dev(f_rows[t_perm]),
                   sparse=feature_matmul == "sparse", truth=truth,
                   dims=(f, *hidden, int(data["output_dim"])))
    if not prob.sparse:
        prob.x = prob.features(prob.f_values)[0]
    return prob


@dataclasses.dataclass
class Dropout:
    """One training step's dropout: X with its kept values scaled (and Xᵀ
    for a sparse X), each hidden layer's kept mask, and 1-p, which a kept
    value is divided by."""

    x: torch.Tensor
    x_t: torch.Tensor | None
    hidden_kept: tuple[torch.Tensor, ...]
    keep: float

    def hidden(self, layer: int, h: torch.Tensor) -> torch.Tensor:
        return torch.where(self.hidden_kept[layer], h / self.keep,
                           torch.zeros((), device=h.device))


class Model:
    """Forward, loss and hand-written gradients of the GCN."""

    def __init__(self, prob: Problem, weight_decay: float, precision: str = "float32"):
        if precision not in reference.PRECISIONS:
            raise ValueError(f"precision must be one of {reference.PRECISIONS}")
        self.p, self.wd, self.precision = prob, weight_decay, precision

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return reference.matmul(a, b, self.precision)

    def forward(self, w: list[torch.Tensor], drop: Dropout | None = None):
        """(logits, (pre-activation, hidden layer, its dropped form) of each
        hidden layer); without ``drop`` the evaluation forward."""
        h = self.p.x if drop is None else drop.x
        layers = []
        for i, wi in enumerate(w):
            pre = self.p.adj @ self._mm(h, wi)
            if i == len(w) - 1:
                return pre, layers
            act = torch.relu(pre)
            h = act if drop is None else drop.hidden(i, act)
            layers.append((pre, act, h))

    def loss(self, logits: torch.Tensor, truth: torch.Tensor, w0: torch.Tensor):
        """(masked mean cross-entropy + wd/2·||W1||², d loss / d logits)."""
        mask = truth >= 0
        count = mask.sum()
        safe = torch.where(mask, truth, torch.zeros_like(truth))
        shifted = logits - logits.max(dim=1, keepdim=True).values
        log_z = torch.log(torch.exp(shifted).sum(dim=1))
        per_node = log_z - shifted.gather(1, safe[:, None])[:, 0]
        ce = torch.where(mask, per_node, torch.zeros_like(per_node)).sum() / count
        loss = ce + 0.5 * self.wd * torch.sum(w0 * w0)
        grad = torch.softmax(logits, dim=1)
        grad[torch.arange(len(safe), device=safe.device), safe] -= 1.0
        grad = torch.where(mask[:, None], grad, torch.zeros_like(grad)) / count
        return loss, grad

    def gradients(self, w: list[torch.Tensor], truth: torch.Tensor, drop: Dropout | None = None):
        """(loss at ``w``, [dW of each layer], the hidden layers) of the
        forward with ``drop``."""
        logits, layers = self.forward(w, drop)
        loss, d_pre = self.loss(logits, truth, w[0])
        grads = [None] * len(w)
        for i in range(len(w) - 1, 0, -1):
            pre, _, h = layers[i - 1]
            dz = self.p.adj_t @ d_pre
            grads[i] = self._mm(h.T.contiguous(), dz)
            d_h = self._mm(dz, w[i].T.contiguous())
            d_pre = (d_h if drop is None else drop.hidden(i - 1, d_h)) * (pre > 0)
        dz = self.p.adj_t @ d_pre
        x = self.p.x if drop is None else drop.x
        x_t = x.T.contiguous() if not self.p.sparse else (
            drop.x_t if drop is not None else self.p.features(self.p.f_values)[1])
        grads[0] = self._mm(x_t, dz) + self.wd * w[0]
        return loss, grads, [act for _, act, _ in layers]

    def eval_loss(self, w: list[torch.Tensor], truth: torch.Tensor) -> torch.Tensor:
        logits, _ = self.forward(w)
        return self.loss(logits, truth, w[0])[0]


def train_steps(prob: Problem, w_init: list[torch.Tensor], steps: int, lr: float,
                weight_decay: float, precision: str = "float32", fault: str | None = None,
                masks=None, rate: float = 0.0) -> Readings:
    """``steps`` full-batch Adam steps from ``w_init``, step i's training
    forward with dropout at ``rate`` by ``masks[i]`` (X's kept nnz, each
    hidden layer's kept mask), none where ``rate`` is 0. ``fault`` plants one
    of the comparison's faults in the reference: 'state_unchanged' (a step
    leaves the weights and moments as they were), 'half_batch' (the loss and
    gradient over the first half of the training nodes, the mean over
    those), 'answer_altered' (each loss reported 1% high), 'dropout_skipped'
    (every value kept), 'hidden_dropout_skipped' (every value of the last
    hidden layer kept), 'dropout_unscaled' (kept values not scaled by
    1/(1-p)), 'dropout_rate' (masks of its own, drawn at p + ``RATE_FAULT``),
    'grad0_scaled' (the first layer's gradient 0.9 of itself)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    reference.use_float32()
    device = prob.truth[1].device
    model = Model(prob, weight_decay, precision)
    truth_train = prob.truth[1]
    if fault == "half_batch":
        ids = torch.nonzero(truth_train >= 0)[:, 0]
        truth_train = truth_train.clone()
        truth_train[ids[len(ids) // 2:]] = -1
    if rate > 0 and fault == "dropout_skipped":
        masks = [tuple(torch.ones_like(m) for m in step) for step in masks]
    if rate > 0 and fault == "hidden_dropout_skipped":
        masks = [(*step[:-1], torch.ones_like(step[-1])) for step in masks]
    if rate > 0 and fault == "dropout_rate":
        gen = torch.Generator().manual_seed(int(masks[0][0].sum()))
        masks = [tuple(torch.rand(m.shape, generator=gen) >= rate + RATE_FAULT for m in step)
                 for step in masks]
    keep = 1.0 if fault == "dropout_unscaled" else 1.0 - rate
    w = [t.to(device=device, dtype=torch.float32).clone() for t in w_init]
    m = [torch.zeros_like(t) for t in w]
    v = [torch.zeros_like(t) for t in w]
    report = 1.01 if fault == "answer_altered" else 1.0
    train_loss, val_loss, grad1, active = [], [], [], []
    for t in range(1, steps + 1):
        drop = None
        if rate > 0:
            kept, *hidden_kept = (mask.to(device) for mask in masks[t - 1])
            values = torch.where(kept, prob.f_values / keep, torch.zeros((), device=device))
            drop = Dropout(*prob.features(values), tuple(hidden_kept), keep)
        loss, grads, hidden = model.gradients(w, truth_train, drop)
        active.append(tuple((h > 0).cpu() for h in hidden))
        if fault == "grad0_scaled":
            grads[0] = grads[0] * 0.9
        train_loss.append(float(loss) * report)
        if t == 1:
            grad1 = [g.clone() for g in grads]
        if fault != "state_unchanged":
            reference.adam_step(w, m, v, grads, t, lr)
        val_loss.append(float(model.eval_loss(w, prob.truth[2])) * report)
    test = float(model.eval_loss(w, prob.truth[3])) * report
    return Readings(train_loss=train_loss, val_loss=val_loss, test_loss=test,
                    grad1=[g.cpu() for g in grad1],
                    change=[(a.cpu() - b.cpu().float()) for a, b in zip(w, w_init)],
                    masks=masks if rate > 0 else None, active=active,
                    x_nonzero=prob.x_nonzero.cpu(), keep=1.0 - rate)


def reference_inputs(data: dict, config: dict, traffic: dict, device) -> Problem:
    """The reference's inputs of a configuration's graph, built once a run."""
    return build_problem(data, hidden_dims(config["model"]), traffic["feature_matmul"], device)


def follow(prob: Problem, config: dict, seed: int, readings: Readings,
           precision: str = "float32", fault: str | None = None) -> Readings:
    """The reference over the comparison's steps of the job of ``seed``
    (Glorot weights from it, ``STEPS`` steps at the configuration's
    ``model`` settings), with the program's dropout masks from ``readings``:
    the one call that the benchmark's runs and its readings share."""
    model = config["model"]
    return train_steps(prob, reference.glorot_weights(prob.dims, seed), STEPS,
                       model["learning_rate"], model["weight_decay"], precision=precision,
                       fault=fault, masks=readings.masks, rate=model["dropout"])


# ---- the comparison ------------------------------------------------------

def mask_z(prog: Readings, ref: Readings) -> float:
    """``prog``'s masks against independent draws that keep ``ref.keep``,
    counted where a mask shows: X's nonzeros, and the hidden entries that are
    positive in the reference (a dropped value and a zero read alike)."""
    q = ref.keep
    if q >= 1.0:
        return 0.0
    if prog.masks is None or len(prog.masks) != len(ref.active):
        return math.inf
    agree = q * q + (1.0 - q) ** 2
    zs, prev = [], None
    for step, act in zip(prog.masks, ref.active):
        shown = (ref.x_nonzero, *act)
        if len(step) != len(shown) or any(m.shape != s.shape for m, s in zip(step, shown)):
            return math.inf
        step = [m & s for m, s in zip(step, shown)]
        zs += [compare.z(int(m.sum()), int(s.sum()), q) for m, s in zip(step, shown)]
        if prev is not None:
            for m, s, p_m, p_s in zip(step, shown, *prev):
                both = p_s & s
                zs.append(compare.z(int(((p_m == m) & both).sum()), int(both.sum()), agree))
        prev = (step, shown)
    return compare.worst(zs)


def numbers(prog: Readings, ref: Readings) -> dict[str, float]:
    """The compared numbers of ``prog`` judged against ``ref``; a non-finite
    reading reads as infinite."""
    out_gap, out_diff = compare.grad_numbers(prog.grad1[-1], ref.grad1[-1])
    l0_gap, l0_diff = compare.grad_numbers(prog.grad1[0], ref.grad1[0])
    return {"loss_gap": compare.loss_gap([*prog.train_loss, *prog.val_loss, prog.test_loss],
                                         [*ref.train_loss, *ref.val_loss, ref.test_loss]),
            "grad1_gap": out_gap,
            "change_gap": compare.change_gap(prog.change, ref.change, ref.grad1),
            "grad1_diff": out_diff, "grad1_l0_gap": l0_gap, "grad1_l0_diff": l0_diff,
            "mask_z": mask_z(prog, ref)}


# ---- the roofline --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shapes:
    nodes: int
    nnz: int           # adjacency nnz, self-loops included
    feature_nnz: int   # nnz of the sparse feature matrix
    dims: tuple[int, ...]  # (F, each hidden width, C)
    dtype: str = "float32"
    feature_matmul: str = "dense"


def adjacency_pass(s: Shapes, width: int) -> Work:
    item = ITEMSIZE[s.dtype]
    return Work(bytes=s.nnz * INDEX_BYTES + (s.nodes + 1) * INDEX_BYTES
                + 2 * s.nodes * width * item,
                flops=2.0 * s.nnz * width)


def layer0_read(s: Shapes) -> Work:
    """One read of x for a layer-0 product or dW, with that product's
    operations."""
    f, h = s.dims[:2]
    item = ITEMSIZE[s.dtype]
    if s.feature_matmul == "sparse":
        return Work(bytes=s.feature_nnz * (item + INDEX_BYTES) + (s.nodes + 1) * INDEX_BYTES,
                    flops=2.0 * s.feature_nnz * h)
    return Work(bytes=s.nodes * f * item, flops=2.0 * s.nodes * f * h)


def _passes(s: Shapes, widths) -> Work:
    total = Work()
    for w in widths:
        total = total + adjacency_pass(s, w)
    return total


def epoch(s: Shapes, early_stopping: bool) -> dict[str, Work]:
    """{'aggregation', 'layer0'} of one epoch."""
    widths = s.dims[1:]
    if early_stopping:
        # train forward, backward from the last layer, evaluation forward; x
        # for the training product, dW and the evaluation product
        return {"aggregation": _passes(s, (*widths, *widths[::-1], *widths)),
                "layer0": layer0_read(s) * 3}
    # fused pair: forward at twice each width, backward from the last layer;
    # x for the pair's products (one read) and for dW; the pair's second
    # product's operations
    pair = layer0_read(s)
    return {"aggregation": _passes(s, (*(2 * w for w in widths), *widths[::-1])),
            "layer0": pair + Work(flops=pair.flops) + layer0_read(s)}


def evaluation(s: Shapes) -> dict[str, Work]:
    """{'aggregation', 'layer0'} of one evaluation forward."""
    return {"aggregation": _passes(s, s.dims[1:]), "layer0": layer0_read(s)}


def shapes(prep: Prepared, data: dict, config: dict, traffic: dict) -> Shapes:
    return Shapes(nodes=int(data["num_nodes"]), nnz=len(data["indices"]),
                  feature_nnz=len(data["f_values"]), dims=tuple(prep.cfg.layer_dims()),
                  dtype=config["compute_dtype"], feature_matmul=traffic["feature_matmul"])


def job_work(s: Shapes, epochs: int, early_stopping: bool) -> dict[str, Work]:
    """{'aggregation', 'layer0', 'total'} of a job of ``epochs`` epochs: the
    epochs, the fixed-length loop's trailing evaluation and the test one;
    with sparse features also 'layer0_spmm', layer 0's work again, which
    then runs on the aggregation kernels."""
    per = epoch(s, early_stopping)
    ev = evaluation(s)
    n_evals = 1 if early_stopping else 2
    out = {k: per[k] * epochs + ev[k] * n_evals for k in per}
    out["total"] = out["aggregation"] + out["layer0"]
    if s.feature_matmul == "sparse":
        out["layer0_spmm"] = out["layer0"]
    return out
