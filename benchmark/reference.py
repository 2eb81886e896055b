"""Plain PyTorch reference of the benchmark's training job: Kipf & Welling's
two-layer GCN (arXiv:1609.02907) with the reference program's loss and Adam.

It imports nothing of the program and takes nothing the program made but the
dropout masks it drew (below). From the generated arrays alone it works out the normalised adjacency
Â = D^-1/2 (A+I) D^-1/2 (the self-loop is already the first entry of each
row; D counts it), the Glorot initial weights from the job's seed, and every
step: forward, the masked softmax cross-entropy plus wd/2·||W1||², the
gradients written out by hand (no autograd), and Adam with the reference's
step size lr·sqrt(1-β2^t)/(1-β1^t) and eps outside the root. It keeps the
nodes in the order generated, which is the program's own on the cells'
backend (ell relabels nothing), so the masks read back line up with its rows.

Dropout is data here: the program draws its masks inside the timed path, and
a reference that redrew the same masks would tie the program to today's
order of random draws (PERF.md). So the reference takes each step's kept
masks as the program drew them (program.check_steps reads them back) and
applies them itself: kept values scaled by 1/(1-p), as Kipf & Welling's
inverted dropout does; compare.py judges the masks themselves apart.
``precision='tf32'`` is the control of the comparison: every dense product's
operands rounded to TF32 (10 mantissa bits, to nearest even), the precision
a float32 product runs in on this card with TF32 on; the sparse products stay
float32, as cuSPARSE has no TF32 mode.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
PRECISIONS = ("float32", "tf32")
STEPS = 3  # the comparison's steps: one epoch, then two from its state


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to nearest even at TF32's 10 mantissa bits."""
    bits = t.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def _csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray, shape,
         device) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sparse CSR is "in beta state"
        return torch.sparse_csr_tensor(
            torch.from_numpy(indptr.astype(np.int64)), torch.from_numpy(indices.astype(np.int64)),
            torch.from_numpy(values.astype(np.float32)), size=shape,
            check_invariants=False).to(device)


def _transpose_csr(indptr: np.ndarray, indices: np.ndarray, values: np.ndarray,
                   n_cols: int):
    rows = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices, kind="stable")
    t_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=n_cols), out=t_indptr[1:])
    return t_indptr, rows[order], values[order]


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
            return (_csr_t(self.x.crow_indices(), self.f_cols, values, (n, f)),
                    _csr_t(self.t_crow, self.t_cols, values[self.t_perm], (f, n)))
        dense = torch.zeros(n, f, device=values.device)
        dense[self.f_rows, self.f_cols] = values
        return dense, None


def _csr_t(crow: torch.Tensor, cols: torch.Tensor, values: torch.Tensor, shape) -> torch.Tensor:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # sparse CSR is "in beta state"
        return torch.sparse_csr_tensor(crow, cols, values, size=shape, check_invariants=False)


def build_problem(data: dict, hidden: tuple[int, ...], feature_matmul: str,
                  device) -> Problem:
    """The reference's inputs from the generated arrays (synth.make_synthetic)."""
    n, f = int(data["num_nodes"]), int(data["input_dim"])
    indptr = data["indptr"].astype(np.int64)
    indices = data["indices"].astype(np.int64)
    deg = np.diff(indptr).astype(np.float64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    coef = (1.0 / np.sqrt(deg[rows] * deg[indices])).astype(np.float32)
    adj = _csr(indptr, indices, coef, (n, n), device)
    adj_t = _csr(*_transpose_csr(indptr, indices, coef, n), (n, n), device)
    f_indptr = data["f_indptr"].astype(np.int64)
    f_indices = data["f_indices"].astype(np.int64)
    f_values = data["f_values"].astype(np.float32)
    f_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(f_indptr))
    t_crow, _, t_perm = _transpose_csr(f_indptr, f_indices, np.arange(len(f_indices)), f)
    x = _csr(f_indptr, f_indices, f_values, (n, f), device)

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


def glorot_weights(dims: tuple[int, ...], seed: int) -> list[torch.Tensor]:
    """Glorot uniform weights in (-a, a), a = sqrt(6/(fan_in+fan_out))
    (the reference program's variable.cpp), drawn in float32 layer by layer
    from one CPU ``torch.Generator`` seeded with the job's seed."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for fan_in, fan_out in zip(dims[:-1], dims[1:]):
        a = (6.0 / (fan_in + fan_out)) ** 0.5
        out.append(torch.empty(fan_in, fan_out).uniform_(-a, a, generator=gen))
    return out


@dataclasses.dataclass
class Dropout:
    """One training step's dropout: X with its kept values scaled (and Xᵀ
    for a sparse X), the hidden layer's kept mask, and 1-p, which a kept
    value is divided by."""

    x: torch.Tensor
    x_t: torch.Tensor | None
    hidden_kept: torch.Tensor
    keep: float

    def hidden(self, h: torch.Tensor) -> torch.Tensor:
        return torch.where(self.hidden_kept, h / self.keep, torch.zeros((), device=h.device))


class Model:
    """Forward, loss and hand-written gradients of the two-layer GCN."""

    def __init__(self, prob: Problem, weight_decay: float, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.p, self.wd, self.precision = prob, weight_decay, precision

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.layout == torch.sparse_csr:
            return a @ b
        if self.precision == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return a @ b

    def forward(self, w: list[torch.Tensor], drop: Dropout | None = None):
        """(logits, (pre-activation, hidden layer, its dropped form)); without
        ``drop`` the evaluation forward."""
        z0 = self._mm(self.p.x if drop is None else drop.x, w[0])
        pre = self.p.adj @ z0
        h1 = torch.relu(pre)
        d1 = h1 if drop is None else drop.hidden(h1)
        logits = self.p.adj @ self._mm(d1, w[1])
        return logits, (pre, h1, d1)

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
        """(loss at ``w``, [dW1, dW2], the hidden layer) of the forward with ``drop``."""
        logits, (pre, h1, d1) = self.forward(w, drop)
        loss, d_logits = self.loss(logits, truth, w[0])
        dz1 = self.p.adj_t @ d_logits
        dw1 = self._mm(d1.T.contiguous(), dz1)
        d_d1 = self._mm(dz1, w[1].T.contiguous())
        d_pre = (d_d1 if drop is None else drop.hidden(d_d1)) * (pre > 0)
        dz0 = self.p.adj_t @ d_pre
        x = self.p.x if drop is None else drop.x
        x_t = x.T.contiguous() if not self.p.sparse else (
            drop.x_t if drop is not None else self.p.features(self.p.f_values)[1])
        dw0 = self._mm(x_t, dz0) + self.wd * w[0]
        return loss, [dw0, dw1], h1

    def eval_loss(self, w: list[torch.Tensor], truth: torch.Tensor) -> torch.Tensor:
        logits, _ = self.forward(w)
        return self.loss(logits, truth, w[0])[0]


@dataclasses.dataclass
class Readings:
    """What a job's first steps give, on either side of the comparison."""

    train_loss: list[float]   # step i's loss at the weights before it
    val_loss: list[float]     # the validation loss of the weights after step i
    test_loss: float          # the test loss of the final weights
    grad1: list[torch.Tensor]  # the first step's gradient, a tensor a leaf
    change: list[torch.Tensor]  # final weights less initial ones, a leaf each
    # each step's kept masks (X's nnz in CSR order, bool; the hidden layer
    # [N, H], bool, kept where nonzero): as the program drew them, or as the
    # reference applied them
    masks: list[tuple[torch.Tensor, torch.Tensor]] | None = None
    # the reference's side: each step's hidden layer > 0 (where a hidden mask
    # shows), X's nnz that are not 0, and the kept share 1-p
    active: list[torch.Tensor] | None = None
    x_nonzero: torch.Tensor | None = None
    keep: float = 1.0


FAULTS = ("state_unchanged", "half_batch", "answer_altered", "dropout_skipped",
          "dropout_unscaled", "dropout_rate", "grad0_scaled")
RATE_FAULT = 0.05  # 'dropout_rate' drops this much more than the configuration's rate


def train_steps(prob: Problem, w_init: list[torch.Tensor], steps: int, lr: float,
                weight_decay: float, precision: str = "float32", fault: str | None = None,
                masks=None, rate: float = 0.0) -> Readings:
    """``steps`` full-batch Adam steps from ``w_init``, step i's training
    forward with dropout at ``rate`` by ``masks[i]`` (X's kept nnz, the
    hidden layer's kept mask), none where ``rate`` is 0. ``fault`` plants one
    of the comparison's faults in the reference: 'state_unchanged' (a step
    leaves the weights and moments as they were), 'half_batch' (the loss and
    gradient over the first half of the training nodes, the mean over
    those), 'answer_altered' (each loss reported 1% high), 'dropout_skipped'
    (every value kept), 'dropout_unscaled' (kept values not scaled by
    1/(1-p)), 'dropout_rate' (masks of its own, drawn at p + ``RATE_FAULT``),
    'grad0_scaled' (the first layer's gradient 0.9 of itself)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = prob.truth[1].device
    model = Model(prob, weight_decay, precision)
    truth_train = prob.truth[1]
    if fault == "half_batch":
        ids = torch.nonzero(truth_train >= 0)[:, 0]
        truth_train = truth_train.clone()
        truth_train[ids[len(ids) // 2:]] = -1
    if rate > 0 and fault == "dropout_skipped":
        masks = [(torch.ones_like(m0), torch.ones_like(m1)) for m0, m1 in masks]
    if rate > 0 and fault == "dropout_rate":
        gen = torch.Generator().manual_seed(int(masks[0][0].sum()))
        masks = [tuple(torch.rand(m.shape, generator=gen) >= rate + RATE_FAULT for m in pair)
                 for pair in masks]
    keep = 1.0 if fault == "dropout_unscaled" else 1.0 - rate
    w = [t.to(device=device, dtype=torch.float32).clone() for t in w_init]
    m = [torch.zeros_like(t) for t in w]
    v = [torch.zeros_like(t) for t in w]
    report = 1.01 if fault == "answer_altered" else 1.0
    train_loss, val_loss, grad1, active = [], [], [], []
    for t in range(1, steps + 1):
        drop = None
        if rate > 0:
            kept, hidden_kept = (mask.to(device) for mask in masks[t - 1])
            values = torch.where(kept, prob.f_values / keep, torch.zeros((), device=device))
            drop = Dropout(*prob.features(values), hidden_kept, keep)
        loss, grads, h1 = model.gradients(w, truth_train, drop)
        active.append((h1 > 0).cpu())
        if fault == "grad0_scaled":
            grads[0] = grads[0] * 0.9
        train_loss.append(float(loss) * report)
        if t == 1:
            grad1 = [g.clone() for g in grads]
        if fault != "state_unchanged":
            step_size = lr * (1.0 - ADAM_BETA2 ** t) ** 0.5 / (1.0 - ADAM_BETA1 ** t)
            for wi, mi, vi, g in zip(w, m, v, grads):
                mi.mul_(ADAM_BETA1).add_((1.0 - ADAM_BETA1) * g)
                vi.mul_(ADAM_BETA2).add_((1.0 - ADAM_BETA2) * g * g)
                wi.sub_(step_size * mi / (torch.sqrt(vi) + ADAM_EPS))
        val_loss.append(float(model.eval_loss(w, prob.truth[2])) * report)
    test = float(model.eval_loss(w, prob.truth[3])) * report
    return Readings(train_loss=train_loss, val_loss=val_loss, test_loss=test,
                    grad1=[g.cpu() for g in grad1],
                    change=[(a.cpu() - b.cpu().float()) for a, b in zip(w, w_init)],
                    masks=masks if rate > 0 else None, active=active,
                    x_nonzero=prob.x_nonzero.cpu(), keep=1.0 - rate)


def follow(prob: Problem, model: dict, seed: int, masks, precision: str = "float32",
           fault: str | None = None) -> Readings:
    """The reference over the comparison's steps of the job of ``seed``
    (Glorot weights from it, ``STEPS`` steps at the configuration's
    ``model`` settings), with the program's dropout ``masks``: the one call
    that the benchmark's runs and its readings share."""
    return train_steps(prob, glorot_weights(prob.dims, seed), STEPS, model["learning_rate"],
                       model["weight_decay"], precision=precision, fault=fault, masks=masks,
                       rate=model["dropout"])
