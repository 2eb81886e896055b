"""The GCNII family: Chen et al.'s deep GCN with initial residual and identity
mapping ("Simple and Deep Graph Convolutional Networks", ICML 2020,
arXiv:2007.02133), trained full batch by ``cuda_gcn_torch`` (models/gcnii.py).

A configuration's ``model`` gives ``family`` 'gcnii', ``layers`` (the
convolutions), ``hidden_dim`` (their width), ``alpha``, ``lamda``,
``dropout`` (x's and every later layer's input), ``learning_rate``,
``weight_decay`` (the two dense layers) and ``conv_weight_decay`` (the
convolutions); the traffic file a job's ``epochs``, ``early_stopping`` and
``feature_matmul``.

**The program's side** imports ``cuda_gcn_torch`` inside its functions only.
A job is the gcn family's (``run_job``: ``train.create_state`` for the job's
seed, ``train.run_epochs_chunked``, ``train.eval_step`` on the test split),
which builds the model ``GCNConfig.model`` names. ``check_steps`` reads back
every mask the program drew in the comparison's steps, from the tensors the
steps save for their backward: the dropped x opens a step, then each
convolution's kept mask and the output layer's (bool [N, H]), in the order
they are drawn.

**The reference** (``reference_inputs``, ``follow``) imports nothing of the
program and nothing of JAX: plain float32 PyTorch with TF32 off
(``reference.use_float32``), Â = D^-1/2 (A + I) D^-1/2 as an edge list in
CSR order summed with ``index_select`` / ``index_add_`` in blocks of edges
(its gradient the same sum over the edges the other way, ``_Aggregate``),
the masked cross-entropy plus conv_wd/2 · Σ_l ||W_l||² + wd/2 · the dense
layers' weights and biases, autograd's gradients and the reference
program's Adam (``reference.adam_step``). The weights are drawn from the
job's seed in the program's order: the convolutions' U(−1/√H, 1/√H), then
the input and the output layer's weight and bias, U(−1/√fan_in, 1/√fan_in).
Departures from the paper, each where the program departs too: synthetic
graphs and features with C of their own (41 at reddit's size; GCNII never
ran on reddit); the fused epoch's evaluation half; no early stopping within
a job; dropout masks are data (the program's).

**The compared numbers** (``NUMBERS``): ``loss_gap`` over each step's
training loss, the validation loss after it and the test loss;
``grad1_gap``, ``grad1_diff`` of the output layer's weight's first gradient
(as the gcn family's); ``grad1_l0_gap``, ``grad1_l0_diff`` of the input
layer's; ``grad1_conv_gap``, ``grad1_conv_diff`` of the first convolution's,
the gradient that crosses all the layers; ``change_gap`` leaf by leaf; and
``mask_z``: every mask against independent draws at the configuration's
rate, in binomial standard deviations, over each step's kept share of X's
nonzeros and of each later layer's entries, and over the share on which two
consecutive steps' masks agree.

**Faults** (``FAULTS``) planted in the reference: ``state_unchanged``,
``half_batch``, ``theta_off_by_one`` (θ_l from l + 1),
``residual_dropped_last`` (α = 0 in the last layer), ``identity_skipped``
(θ = 1: no identity mapping), ``conv_decay_as_dense`` (the convolutions
decayed at the dense layers' 5e-4), ``conv_dropout_skipped`` (the last
convolution's input kept whole: the first one's reaches the logits through 63
layers scaled by (1 − α)^63 and moves no loss at 64 layers), ``dropout_rate``
(masks of the reference's own, drawn at p + 0.05: what ``mask_z`` reads of a
mask drawn at another rate). ``CONTROL``: TF32-rounded dense products.

**The roofline** (``job_work``) from shapes alone. A blended pass at width d
reads the columns and the coefficients (8 bytes an nnz), h and h0 once and
writes s once, 2·nnz·d + 3·N·d operations; the backward's transposed pass
reads the columns, the coefficients and g and writes once, 2·nnz·d. A
fixed-length epoch is the fused pair: each convolution's pair pass at 2·H
and its transposed pass at H; an evaluation the single pass at H a layer.
The dense products: each convolution's identity mapping (both halves
forward, then dW and the input's gradient), the output layer's, each
operand read and output written once, 2·N·H·H operations; layer 0 on dense
x reads x once for the pair and once for dW (2·N·F·H operations a product),
on sparse x its values and indices. Parts: 'propagation', 'products',
'layer0', 'total'.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import compare, program, reference
from benchmark.families.gat import _matmul  # a dense product, TF32-rounded at 'tf32'
from benchmark.families.gcn import Prepared, _train, run_job  # noqa: F401 (run_job: the API's)
from benchmark.roofline import INDEX_BYTES, ITEMSIZE, Work

NUMBERS = ("loss_gap", "grad1_gap", "grad1_diff", "grad1_l0_gap", "grad1_l0_diff",
           "grad1_conv_gap", "grad1_conv_diff", "change_gap", "mask_z")
FAULTS = ("state_unchanged", "half_batch", "theta_off_by_one", "residual_dropped_last",
          "identity_skipped", "conv_decay_as_dense", "conv_dropout_skipped", "dropout_rate")
CONTROL = "tf32"
STEPS = 3  # one epoch, then two from its state (an eager epoch, a capture and its replay)
RATE_FAULT = 0.05  # 'dropout_rate' drops this much more than the configuration's rate
EDGE_BLOCK = 1 << 22  # edges a block of the reference's [E, H] terms
DENSE_DECAY = 5e-4  # 'conv_decay_as_dense': the dense layers' L2 in the paper's setting


@dataclasses.dataclass
class Readings:
    """What a job's first steps give, on either side of the comparison."""

    train_loss: list[float]
    val_loss: list[float]
    test_loss: float
    grad1: dict[str, torch.Tensor]   # the first step's gradient, by parameter
    change: dict[str, torch.Tensor]  # final parameters less initial ones, by parameter
    # each step's kept masks: X's nnz in CSR order, then each later layer's [N, H]
    masks: list[tuple[torch.Tensor, ...]] | None = None
    # the reference's side: where X's mask shows (its nonzeros), the masks a
    # step, and the kept share
    x_nonzero: torch.Tensor | None = None
    layer_masks: int = 0
    keep: float = 1.0


# ---- the program's side --------------------------------------------------

def prepare(config: dict, traffic: dict, data: dict, device: str = "cuda") -> Prepared:
    from cuda_gcn_torch import train
    from cuda_gcn_torch.config import GCNConfig

    model = config["model"]
    cfg = GCNConfig(model="gcnii", hidden_dim=model["hidden_dim"], layers=model["layers"],
                    alpha=model["alpha"], lamda=model["lamda"], dropout=model["dropout"],
                    learning_rate=model["learning_rate"], weight_decay=model["weight_decay"],
                    conv_weight_decay=model["conv_weight_decay"], epochs=traffic["epochs"],
                    early_stopping=traffic["early_stopping"],
                    graphsum_backend=config["graphsum_backend"],
                    compute_dtype=config["compute_dtype"], param_dtype=config["param_dtype"],
                    feature_matmul=traffic["feature_matmul"])
    cfg, graph, x, truths = train.prepare(cfg, program.dataset_of(data), device)
    return Prepared(cfg=cfg, graph=graph, x=x, truths=truths, device=torch.device(device))


class _MaskReader:
    """Reads a training step's masks back from the tensors its forward saves
    for the backward pass (``torch.autograd.graph.saved_tensors_hooks``): the
    layer-0 product's dropped operand (a float tensor of X's shape: [N, F]
    dense, or X's nnz values) opens a step, kept where it is not 0 at X's
    nnz; then each kept mask of a later layer's dropout (a bool [N, H]), in
    order. A mask read during a CUDA graph's capture holds the values of the
    graph's replays, so the masks are moved to the host after the call."""

    def __init__(self, p: Prepared, data: dict):
        x = p.x
        self.dense = isinstance(x, torch.Tensor)
        if self.dense:
            f_indptr = data["f_indptr"].astype(np.int64)
            rows = np.repeat(np.arange(len(f_indptr) - 1, dtype=np.int64), np.diff(f_indptr))
            self.at = torch.from_numpy(rows * x.shape[1] + data["f_indices"]).to(x.device)
        self.x_shapes = {tuple(x.shape)} if self.dense else {(x.nnz,), (x.nnz, 1)}
        self.hidden_shape = (int(data["num_nodes"]), p.cfg.hidden_dim)
        self.steps: list[list] = []

    def pack(self, t: torch.Tensor):
        shape = tuple(t.shape)
        if t.is_floating_point() and shape in self.x_shapes:
            flat = t.reshape(-1)
            self.steps.append([(flat[self.at] if self.dense else flat) != 0])
        elif t.dtype == torch.bool and shape == self.hidden_shape and self.steps:
            self.steps[-1].append(t)
        return t

    def masks(self) -> list[tuple[torch.Tensor, ...]]:
        return [tuple(m.cpu() for m in step) for step in self.steps]


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
    w0 = {n: w.detach().float().cpu().clone() for n, w in state.model.named_parameters()}
    reader = _MaskReader(p, data)
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        first = _train(p, state, 1, p.cfg.dropout).cpu().numpy()
        grad1 = {n: state.opt.m[n].detach().cpu() / (1.0 - AdamParams().beta1) for n in names}
        rest = _train(p, state, 2, p.cfg.dropout).cpu().numpy()
    test_loss, _ = train.eval_step(state.model, p.graph, p.x, p.truths[3],
                                   weight_decay=p.cfg.weight_decay)
    rows = np.concatenate([first, rest])
    change = {n: w.detach().float().cpu() - w0[n] for n, w in state.model.named_parameters()}
    return Readings(train_loss=[float(v) for v in rows[:, 0]],
                    val_loss=[float(v) for v in rows[:, 2]], test_loss=float(test_loss),
                    grad1=grad1, change=change, masks=reader.masks())


# ---- the reference -------------------------------------------------------

@dataclasses.dataclass
class Problem:
    """The inputs of a job as the reference holds them, on ``device``."""

    n: int
    dst: torch.Tensor       # (E,) int64: Â in CSR order, self-loops included
    src: torch.Tensor
    coef: torch.Tensor      # (E,) float32: 1/sqrt(deg(dst)·deg(src))
    x: torch.Tensor         # dense [N, F], or sparse CSR [N, F]
    f_rows: torch.Tensor    # X's nnz in CSR order
    f_cols: torch.Tensor
    f_values: torch.Tensor
    x_nonzero: torch.Tensor
    sparse: bool
    truth: dict[int, torch.Tensor]
    dims: tuple[int, int, int]  # (F, H, C)
    layers: int

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
    indices = data["indices"].astype(np.int64)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    deg = np.diff(indptr).astype(np.float64)
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    coef = (1.0 / np.sqrt(deg[dst] * deg[indices])).astype(np.float32)
    f_indptr = data["f_indptr"].astype(np.int64)
    f_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(f_indptr))
    f_values = data["f_values"].astype(np.float32)
    label, split = data["label"], data["split"]
    model = config["model"]
    prob = Problem(n=n, dst=dev(dst), src=dev(indices), coef=dev(coef),
                   x=reference.csr(f_indptr, data["f_indices"], f_values, (n, f), device),
                   f_rows=dev(f_rows), f_cols=dev(data["f_indices"].astype(np.int64)),
                   f_values=dev(f_values), x_nonzero=dev(f_values != 0),
                   sparse=traffic["feature_matmul"] == "sparse",
                   truth={s: dev(np.where(split == s, label, -1).astype(np.int64))
                          for s in (1, 2, 3)},
                   dims=(f, int(model["hidden_dim"]), int(data["output_dim"])),
                   layers=int(model["layers"]))
    if not prob.sparse:
        prob.x = prob.features(prob.f_values)
    return prob


def init_params(dims: tuple[int, int, int], layers: int, seed: int) -> dict:
    """{w1 ... wL, w_in, b_in, w_out, b_out}, drawn in that order from one CPU
    generator seeded with ``seed``: the convolutions U(−1/√H, 1/√H), each
    dense layer's weight and bias U(−1/√fan_in, 1/√fan_in)."""
    f, hidden, classes = dims
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, bound):
        return torch.empty(*shape).uniform_(-bound, bound, generator=gen)

    params = {f"w{k}": uniform((hidden, hidden), hidden ** -0.5) for k in range(1, layers + 1)}
    for name, fan_in, fan_out in (("in", f, hidden), ("out", hidden, classes)):
        params[f"w_{name}"] = uniform((fan_in, fan_out), fan_in ** -0.5)
        params[f"b_{name}"] = uniform((fan_out,), fan_in ** -0.5)
    return params


def _edge_sum(h: torch.Tensor, into: torch.Tensor, frm: torch.Tensor,
              coef: torch.Tensor) -> torch.Tensor:
    """out[into[e]] += coef[e] · h[frm[e]] over the edges, in blocks of edges."""
    out = torch.zeros_like(h)
    for a in range(0, len(into), EDGE_BLOCK):
        out.index_add_(0, into[a:a + EDGE_BLOCK],
                       coef[a:a + EDGE_BLOCK, None] * h.index_select(0, frm[a:a + EDGE_BLOCK]))
    return out


class _Aggregate(torch.autograd.Function):
    """Â · h over the edge list, and its gradient Âᵀ · g over the same edges
    the other way: autograd of the edge-list sum, without the [E, H] terms it
    would keep for a backward of 64 layers."""

    @staticmethod
    def forward(ctx, h, prob):
        ctx.prob = prob
        return _edge_sum(h, prob.dst, prob.src, prob.coef)

    @staticmethod
    def backward(ctx, g):
        p = ctx.prob
        return _edge_sum(g.contiguous(), p.src, p.dst, p.coef), None


@dataclasses.dataclass
class Model:
    """GCNII's forward and loss as the reference runs them, with a fault
    planted where ``fault`` names one."""

    prob: Problem
    alpha: float
    lamda: float
    weight_decay: float
    conv_weight_decay: float
    precision: str = "float32"
    fault: str | None = None

    def aggregate(self, h: torch.Tensor) -> torch.Tensor:
        return _Aggregate.apply(h, self.prob)

    def theta(self, layer: int) -> float:
        if self.fault == "identity_skipped":
            return 1.0
        return math.log(self.lamda / (layer + (self.fault == "theta_off_by_one")) + 1.0)

    def forward(self, params: dict, x, drop=None):
        """Logits; ``drop`` (the later layers' masks, keep) or None for the
        evaluation forward (x then is the dropped X where ``drop`` is given)."""
        layers = self.prob.layers

        def dropped(h, i):
            if drop is None or (self.fault == "conv_dropout_skipped" and i == layers - 1):
                return h
            return torch.where(drop[0][i], h / drop[1], torch.zeros((), device=h.device))

        h0 = torch.relu(_matmul(x, params["w_in"], self.precision) + params["b_in"])
        h = h0
        for k in range(1, layers + 1):
            alpha = 0.0 if (self.fault == "residual_dropped_last" and k == layers) else self.alpha
            s = (1.0 - alpha) * self.aggregate(dropped(h, k - 1)) + alpha * h0
            t = self.theta(k)
            h = torch.relu(t * _matmul(s, params[f"w{k}"], self.precision) + (1.0 - t) * s)
        return _matmul(dropped(h, layers), params["w_out"], self.precision) + params["b_out"]

    def loss(self, logits, truth, params):
        mask = truth >= 0
        ce = torch.nn.functional.cross_entropy(logits[mask], truth[mask], reduction="mean")
        conv_wd = DENSE_DECAY if self.fault == "conv_decay_as_dense" else self.conv_weight_decay
        conv = sum(torch.sum(v * v) for k, v in params.items() if k[1:].isdigit())
        dense = sum(torch.sum(v * v) for k, v in params.items() if not k[1:].isdigit())
        return ce + 0.5 * conv_wd * conv + 0.5 * self.weight_decay * dense


def train_steps(prob: Problem, params: dict, steps: int, lr: float, model: dict, rate: float,
                precision: str = "float32", fault: str | None = None, masks=None) -> Readings:
    """``steps`` Adam steps from ``params``, step t's training forward with
    dropout by ``masks[t]`` (none where the rate is 0)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    reference.use_float32()
    device = prob.dst.device
    net = Model(prob, model["alpha"], model["lamda"], model["weight_decay"],
                model["conv_weight_decay"], precision, fault)
    truth = prob.truth[1]
    if fault == "half_batch":
        ids = torch.nonzero(truth >= 0)[:, 0]
        truth = truth.clone()
        truth[ids[len(ids) // 2:]] = -1
    if rate > 0 and fault == "dropout_rate":
        gen = torch.Generator().manual_seed(int(masks[0][0].sum()))
        masks = [(step[0], *(torch.rand(m.shape, generator=gen) >= rate + RATE_FAULT
                             for m in step[1:])) for step in masks]
    w = {k: v.to(device).clone() for k, v in params.items()}
    m = [torch.zeros_like(v) for v in w.values()]
    v = [torch.zeros_like(t) for t in w.values()]
    train_loss, val_loss, grad1 = [], [], []
    for t in range(1, steps + 1):
        x, drop = prob.x, None
        if rate > 0:
            kept, *hidden = (mask.to(device) for mask in masks[t - 1])
            values = torch.where(kept, prob.f_values / (1.0 - rate),
                                 torch.zeros((), device=device))
            x, drop = prob.features(values), (hidden, 1.0 - rate)
        leaves = {k: t_.detach().clone().requires_grad_(True) for k, t_ in w.items()}
        loss = net.loss(net.forward(leaves, x, drop), truth, leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        train_loss.append(float(loss.detach()))
        del loss, leaves, x, drop
        if t == 1:
            grad1 = [g.detach().clone() for g in grads]
        if fault != "state_unchanged":
            reference.adam_step(list(w.values()), m, v, list(grads), t, lr)
        del grads
        with torch.no_grad():
            val_loss.append(float(net.loss(net.forward(w, prob.x), prob.truth[2], w)))
    with torch.no_grad():
        test = float(net.loss(net.forward(w, prob.x), prob.truth[3], w))
    return Readings(train_loss=train_loss, val_loss=val_loss, test_loss=test,
                    grad1={k: g.cpu() for k, g in zip(w, grad1)},
                    change={k: w[k].cpu() - params[k].cpu().float() for k in params},
                    masks=masks if rate > 0 else None, x_nonzero=prob.x_nonzero.cpu(),
                    layer_masks=prob.layers + 1, keep=1.0 - rate)


def follow(prob: Problem, config: dict, seed: int, readings: Readings,
           precision: str = "float32", fault: str | None = None) -> Readings:
    """The reference over the comparison's steps of the job of ``seed`` with
    the program's masks from ``readings``."""
    model = config["model"]
    return train_steps(prob, init_params(prob.dims, prob.layers, seed), STEPS,
                       model["learning_rate"], model, model["dropout"], precision=precision,
                       fault=fault, masks=readings.masks)


# ---- the comparison ------------------------------------------------------

def mask_z(prog: Readings, ref: Readings) -> float:
    """``prog``'s masks against independent draws: X's nonzeros and every
    later layer's entries kept at 1 - p; and each mask against the previous
    step's."""
    if ref.keep >= 1.0:
        return 0.0
    if prog.masks is None or len(prog.masks) != len(ref.train_loss):
        return math.inf
    kinds = [ref.x_nonzero] + [None] * ref.layer_masks
    q = ref.keep
    zs, prev = [], None
    for step in prog.masks:
        if len(step) != len(kinds) or step[0].shape != ref.x_nonzero.shape:
            return math.inf
        for i, (m, shown) in enumerate(zip(step, kinds)):
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


def numbers(prog: Readings, ref: Readings) -> dict[str, float]:
    """The compared numbers of ``prog`` judged against ``ref``."""
    out_gap, out_diff = compare.grad_numbers(prog.grad1["w_out"], ref.grad1["w_out"])
    l0_gap, l0_diff = compare.grad_numbers(prog.grad1["w_in"], ref.grad1["w_in"])
    conv_gap, conv_diff = compare.grad_numbers(prog.grad1["w1"], ref.grad1["w1"])
    names = list(ref.change)
    return {"loss_gap": compare.loss_gap([*prog.train_loss, *prog.val_loss, prog.test_loss],
                                         [*ref.train_loss, *ref.val_loss, ref.test_loss]),
            "grad1_gap": out_gap, "grad1_diff": out_diff,
            "grad1_l0_gap": l0_gap, "grad1_l0_diff": l0_diff,
            "grad1_conv_gap": conv_gap, "grad1_conv_diff": conv_diff,
            "change_gap": compare.change_gap([prog.change[k] for k in names],
                                             [ref.change[k] for k in names],
                                             [ref.grad1[k] for k in names]),
            "mask_z": mask_z(prog, ref)}


# ---- the roofline --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shapes:
    nodes: int
    nnz: int                 # Â's nnz, self-loops included
    feature_nnz: int
    dims: tuple[int, int, int]  # (F, H, C)
    layers: int
    dtype: str = "float32"
    feature_matmul: str = "dense"


def blended_pass(s: Shapes, d: int) -> Work:
    """Columns and coefficients once, h and h0 read, s written."""
    item = ITEMSIZE[s.dtype]
    return Work(bytes=s.nnz * (INDEX_BYTES + item) + 3 * s.nodes * d * item,
                flops=2.0 * s.nnz * d + 3.0 * s.nodes * d)


def transposed_pass(s: Shapes, d: int) -> Work:
    """Columns and coefficients once, g read, the gradient written."""
    item = ITEMSIZE[s.dtype]
    return Work(bytes=s.nnz * (INDEX_BYTES + item) + 2 * s.nodes * d * item,
                flops=2.0 * s.nnz * d)


def product(s: Shapes, k: int, m: int) -> Work:
    """[N, k] · [k, m]: the operands read and the output written once."""
    item = ITEMSIZE[s.dtype]
    return Work(bytes=(s.nodes * (k + m) + k * m) * item, flops=2.0 * s.nodes * k * m)


def layer0_read(s: Shapes) -> Work:
    f, h = s.dims[0], s.dims[1]
    item = ITEMSIZE[s.dtype]
    if s.feature_matmul == "sparse":
        return Work(bytes=s.feature_nnz * (item + INDEX_BYTES) + (s.nodes + 1) * INDEX_BYTES,
                    flops=2.0 * s.feature_nnz * h)
    return Work(bytes=s.nodes * f * item, flops=2.0 * s.nodes * f * h)


def epoch(s: Shapes, early_stopping: bool) -> dict[str, Work]:
    _, h, c = s.dims
    fwd, bwd = blended_pass(s, h) * s.layers, transposed_pass(s, h) * s.layers
    conv, out = product(s, h, h) * s.layers, product(s, h, c)
    if early_stopping:  # the training forward and backward, then the evaluation's forward
        return {"propagation": fwd * 2 + bwd, "products": (conv + out) * 4,
                "layer0": layer0_read(s) * 3}
    pair = layer0_read(s)
    return {"propagation": blended_pass(s, 2 * h) * s.layers + bwd,
            "products": (conv + out) * 4, "layer0": pair + Work(flops=pair.flops) + pair}


def evaluation(s: Shapes) -> dict[str, Work]:
    _, h, c = s.dims
    return {"propagation": blended_pass(s, h) * s.layers,
            "products": product(s, h, h) * s.layers + product(s, h, c),
            "layer0": layer0_read(s)}


def shapes(prep: Prepared, data: dict, config: dict, traffic: dict) -> Shapes:
    model = config["model"]
    return Shapes(nodes=int(data["num_nodes"]), nnz=len(data["indices"]),
                  feature_nnz=len(data["f_values"]),
                  dims=(int(data["input_dim"]), int(model["hidden_dim"]),
                        int(data["output_dim"])), layers=int(model["layers"]),
                  dtype=config["compute_dtype"], feature_matmul=traffic["feature_matmul"])


def job_work(s: Shapes, epochs: int, early_stopping: bool) -> dict[str, Work]:
    """{'propagation', 'products', 'layer0', 'total'} of a job of ``epochs``
    epochs: the epochs, the fixed-length loop's trailing evaluation and the
    test one."""
    per = epoch(s, early_stopping)
    ev = evaluation(s)
    n_evals = 1 if early_stopping else 2
    out = {k: per[k] * epochs + ev[k] * n_evals for k in per}
    out["total"] = out["propagation"] + out["products"] + out["layer0"]
    return out
