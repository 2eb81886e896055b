"""A plain PyTorch reference of GCNII (Chen, Wei, Huang, Ding, Li, "Simple and
Deep Graph Convolutional Networks", ICML 2020, arXiv:2007.02133), for the
tests of the port's GCNII (tests/test_torch_gcnii.py).

float32 throughout, with TF32 off for matmul and cuDNN. It imports neither
JAX nor anything of ``cuda_gcn_torch``: the graph comes in as a CSR of numpy
arrays, the weights are drawn here from the job's seed, and the gradients
are autograd's over an edge-list forward (``index_select`` / ``index_add_``).

    h0     = ReLU(dropout(x) · W_in + b_in)
    s_l    = (1 − α) · Â · dropout(h_{l−1}) + α · h0
    h_l    = ReLU(θ_l · s_l · W_l + (1 − θ_l) · s_l),  θ_l = ln(λ/l + 1)
    logits = dropout(h_L) · W_out + b_out

Â = D^-1/2 (A + I) D^-1/2 over the CSR's pattern, whose rows hold their
self-loop already (D counts it). The loss is the masked mean cross-entropy
over the training nodes plus conv_wd/2 · Σ_l ||W_l||² + wd/2 · (||W_in||² +
||b_in||² + ||W_out||² + ||b_out||²): the released code's coupled weight
decay in torch's Adam (two parameter groups: 0.01 on the convolutions, 5e-4
on the dense layers), written as a loss term. Adam is the reference
program's (eps outside the root, bias correction in the step size), as the
port's GCN has it; the released code runs torch's Adam.

Departures from the paper, each where the port departs too:

* the graphs are synthetic (the port's tests' and its benchmark's), with C
  classes of their own (41 at reddit's size; GCNII never ran on reddit);
* a training step of the port's fused epoch also evaluates the weights
  before the step (``train.run_epochs``): the validation loss after step t
  is read in the next step's pass, here by a forward of its own;
* no early stopping within a job (the released code stops on the
  validation loss with a patience of 100);
* dropout is data here: the masks come in (``Dropout``), as the port drew
  them, and a kept value is divided by 1 − p;
* the weights are drawn in the released code's order (the 64 convolutions'
  U(−1/√H, 1/√H), then ``nn.Linear``'s U(−1/√fan_in, 1/√fan_in) for the
  input layer's weight and bias and the output layer's), each weight as the
  [fan_in, fan_out] matrix it is in the port (``nn.Linear`` keeps
  [fan_out, fan_in]); the released code's log-softmax and NLL are the
  cross-entropy here.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def use_float32() -> None:
    """Dense products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


use_float32()


@dataclasses.dataclass
class Graph:
    """Â as an edge list in CSR order: edge e adds coef[e] · h[src[e]] to row dst[e]."""

    n: int
    dst: torch.Tensor   # (E,) int64
    src: torch.Tensor   # (E,) int64
    coef: torch.Tensor  # (E,) float32


def graph_of(indptr: np.ndarray, indices: np.ndarray, device="cpu") -> Graph:
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    deg = np.diff(indptr).astype(np.float64)
    dst = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    coef = (1.0 / np.sqrt(deg[dst] * deg[indices])).astype(np.float32)
    return Graph(n=len(indptr) - 1, dst=torch.from_numpy(dst).to(device),
                 src=torch.from_numpy(indices).to(device), coef=torch.from_numpy(coef).to(device))


def aggregate(h: torch.Tensor, graph: Graph, block: int = 1 << 22) -> torch.Tensor:
    """Â · h, the edges taken in blocks of ``block``."""
    out = torch.zeros_like(h)
    for a in range(0, len(graph.dst), block):
        dst, src = graph.dst[a:a + block], graph.src[a:a + block]
        out = out.index_add(0, dst, graph.coef[a:a + block, None] * h.index_select(0, src))
    return out


def theta(lamda: float, layer: int) -> float:
    return math.log(lamda / layer + 1.0)


def init_params(input_dim: int, hidden: int, classes: int, layers: int, seed: int) -> dict:
    """{w1 ... wL, w_in, b_in, w_out, b_out}, drawn in that order from one CPU
    generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, bound):
        return torch.empty(*shape).uniform_(-bound, bound, generator=gen)

    params = {f"w{k}": uniform((hidden, hidden), hidden ** -0.5) for k in range(1, layers + 1)}
    for name, fan_in, fan_out in (("in", input_dim, hidden), ("out", hidden, classes)):
        params[f"w_{name}"] = uniform((fan_in, fan_out), fan_in ** -0.5)
        params[f"b_{name}"] = uniform((fan_out,), fan_in ** -0.5)
    return params


@dataclasses.dataclass
class Dropout:
    """One training step's kept masks: x's [N, F], then each convolution's
    input and the output layer's input [N, H], in the order they are applied;
    a kept value is divided by ``keep`` (1 - p)."""

    x: torch.Tensor | None
    hidden: list
    keep: float


def _drop(v: torch.Tensor, mask, keep: float) -> torch.Tensor:
    if mask is None:
        return v
    return torch.where(mask, v / keep, torch.zeros((), device=v.device))


@dataclasses.dataclass
class Settings:
    alpha: float = 0.1
    lamda: float = 0.5
    weight_decay: float = 5e-4
    conv_weight_decay: float = 0.01


def forward(params: dict, x: torch.Tensor, graph: Graph, s: Settings,
            drop: Dropout | None = None) -> torch.Tensor:
    """Logits [N, C]; without ``drop`` the evaluation forward."""
    layers = sum(1 for k in params if k[1:].isdigit())

    def dropped(v, i):
        return v if drop is None else _drop(v, drop.hidden[i], drop.keep)

    xd = x if drop is None else _drop(x, drop.x, drop.keep)
    h0 = torch.relu(xd @ params["w_in"] + params["b_in"])
    h = h0
    for k in range(1, layers + 1):
        sup = (1.0 - s.alpha) * aggregate(dropped(h, k - 1), graph) + s.alpha * h0
        t = theta(s.lamda, k)
        h = torch.relu(t * (sup @ params[f"w{k}"]) + (1.0 - t) * sup)
    return dropped(h, layers) @ params["w_out"] + params["b_out"]


def loss_of(logits: torch.Tensor, truth: torch.Tensor, params: dict, s: Settings) -> torch.Tensor:
    """Masked mean cross-entropy over the nodes with truth >= 0, plus the L2 terms."""
    mask = truth >= 0
    ce = torch.nn.functional.cross_entropy(logits[mask], truth[mask], reduction="mean")
    conv = sum(torch.sum(v * v) for k, v in params.items() if k[1:].isdigit())
    dense = sum(torch.sum(v * v) for k, v in params.items() if not k[1:].isdigit())
    return ce + 0.5 * s.conv_weight_decay * conv + 0.5 * s.weight_decay * dense


def gradients(params: dict, x, graph, truth, s: Settings, drop: Dropout | None = None):
    """(loss, logits, {name: gradient}) at ``params``, by autograd."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    logits = forward(leaves, x, graph, s, drop)
    loss = loss_of(logits, truth, leaves, s)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), logits.detach(), dict(zip(leaves, grads))


def adam_step(params: dict, m: dict, v: dict, grads: dict, t: int, lr: float) -> None:
    """Step ``t`` (from 1) of the reference program's Adam, in place."""
    step = lr * math.sqrt(1.0 - ADAM_BETA2 ** t) / (1.0 - ADAM_BETA1 ** t)
    for k, g in grads.items():
        m[k].mul_(ADAM_BETA1).add_((1.0 - ADAM_BETA1) * g)
        v[k].mul_(ADAM_BETA2).add_((1.0 - ADAM_BETA2) * g * g)
        params[k].sub_(step * m[k] / (torch.sqrt(v[k]) + ADAM_EPS))


def train_steps(params: dict, x, graph, truth_train, truth_val, s: Settings, lr: float,
                drops: list) -> tuple[list[float], list[float], dict]:
    """One Adam step a ``drops`` entry (its masks, or None): (each step's
    training loss at the weights before it, the validation loss after it,
    the final parameters)."""
    params = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    train, val = [], []
    for t, drop in enumerate(drops, start=1):
        loss, _, grads = gradients(params, x, graph, truth_train, s, drop)
        train.append(float(loss))
        adam_step(params, m, v, grads, t, lr)
        with torch.no_grad():
            val.append(float(loss_of(forward(params, x, graph, s), truth_val, params, s)))
    return train, val, params
