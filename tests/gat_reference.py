"""A plain PyTorch reference of the graph attention network (Veličković et
al., "Graph Attention Networks", ICLR 2018, arXiv:1710.10903), for the tests
of the port's GAT (tests/test_torch_gat.py).

float32 throughout, with TF32 off for matmul and cuDNN. It imports neither
JAX nor anything of ``cuda_gcn_torch``: the graph comes in as a CSR of
numpy arrays, the weights are drawn here from the job's seed, and the
gradients are autograd's over an edge-list forward (``index_select`` /
``index_add_``).

A layer with K heads of F' features (eqs. 1-4, 6):

    z = h · W                                  [N, K·F']
    e_ij,k = LeakyReLU(a_l,k · z_i,k + a_r,k · z_j,k)   for j in N(i) ∪ {i}
    α_ij,k = softmax over j of e_ij,k
    h'_i,k = Σ_j α_ij,k z_j,k

a hidden layer concatenating its heads and applying ELU, the output layer
averaging them; dropout on both layers' inputs and on α.

Departures from the paper, each where the port departs too:

* the neighbourhood N(i) ∪ {i} is the row of Â's pattern, which holds the
  self-loop already (the graph's CSR has it first in each row);
* no bias terms, as in the paper's equations (its released code adds one);
* the L2 penalty covers every weight and attention vector (the paper says
  λ = 5e-4 without naming the parameters);
* an attention vector [K, F'] is Glorot-initialised as a matrix of that
  shape;
* dropout is data here: the masks come in (``Dropout``), as the port drew
  them, and a kept value is divided by 1 - p;
* the loss is the masked mean cross-entropy over the training nodes plus
  the L2 term, and Adam is the reference program's (eps outside the root,
  bias correction in the step size), as the port's GCN has them.
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
    """Â's pattern as an edge list in CSR order: edge e feeds row dst[e] from
    row src[e]."""

    n: int
    dst: torch.Tensor  # (E,) int64
    src: torch.Tensor  # (E,) int64


def graph_of(indptr: np.ndarray, indices: np.ndarray, device="cpu") -> Graph:
    indptr = np.asarray(indptr, np.int64)
    dst = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    return Graph(n=len(indptr) - 1, dst=torch.from_numpy(dst).to(device),
                 src=torch.from_numpy(np.asarray(indices, np.int64)).to(device))


def glorot(fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(fan_in, fan_out).uniform_(-a, a, generator=generator)


def init_params(dims: tuple[int, ...], heads: tuple[int, ...], seed: int) -> dict:
    """{w1, att_l1, att_r1, w2, ...}: Glorot, drawn in that order from one CPU
    generator seeded with ``seed``. ``dims`` (F, F1', ..., C) gives the input
    width, each hidden layer's features a head and the classes."""
    gen = torch.Generator().manual_seed(seed)
    params, fan_in = {}, dims[0]
    for i, k in enumerate(heads):
        params[f"w{i + 1}"] = glorot(fan_in, k * dims[i + 1], gen)
        params[f"att_l{i + 1}"] = glorot(k, dims[i + 1], gen)
        params[f"att_r{i + 1}"] = glorot(k, dims[i + 1], gen)
        fan_in = k * dims[i + 1]
    return params


@dataclasses.dataclass
class Dropout:
    """One training step's kept masks: x's [N, F], each later layer's input
    [N, width], and each layer's attention [E, K] in the graph's edge order;
    a kept value is divided by ``keep`` (1 - p), ``att_keep`` for α."""

    x: torch.Tensor | None
    hidden: list
    attention: list
    keep: float
    att_keep: float


def _drop(v: torch.Tensor, mask, keep: float) -> torch.Tensor:
    if mask is None:
        return v
    return torch.where(mask, v / keep, torch.zeros((), device=v.device))


def attention_layer(z: torch.Tensor, a_l: torch.Tensor, a_r: torch.Tensor, graph: Graph,
                    heads: int, slope: float, att_mask=None, att_keep: float = 1.0,
                    block: int = 1 << 22) -> torch.Tensor:
    """h' [N, K·F'] of z [N, K·F'] (eqs. 1-4), the edges taken in blocks of
    ``block`` for the [E, K, F'] terms."""
    n = z.shape[0]
    z3 = z.view(n, heads, -1)
    sl = (z3 * a_l).sum(-1)
    sr = (z3 * a_r).sum(-1)
    e = torch.nn.functional.leaky_relu(sl.index_select(0, graph.dst)
                                       + sr.index_select(0, graph.src), slope)
    m = torch.full((n, heads), -math.inf, device=z.device).scatter_reduce(
        0, graph.dst[:, None].expand(-1, heads), e.detach(), "amax")
    p = torch.exp(e - m.index_select(0, graph.dst))
    den = torch.zeros(n, heads, device=z.device).index_add(0, graph.dst, p)
    alpha = _drop(p / den.index_select(0, graph.dst), att_mask, att_keep)
    out = torch.zeros_like(z3)
    for a in range(0, len(graph.dst), block):
        dst, src = graph.dst[a:a + block], graph.src[a:a + block]
        out = out.index_add(0, dst, alpha[a:a + block, :, None] * z3.index_select(0, src))
    return out.view(n, -1)


def forward(params: dict, x: torch.Tensor, graph: Graph, heads: tuple[int, ...], slope: float,
            drop: Dropout | None = None) -> torch.Tensor:
    """Logits [N, C]; without ``drop`` the evaluation forward."""
    h = x if drop is None else _drop(x, drop.x, drop.keep)
    for i, k in enumerate(heads):
        if i:
            h = h if drop is None else _drop(h, drop.hidden[i - 1], drop.keep)
        z = h @ params[f"w{i + 1}"]
        h = attention_layer(z, params[f"att_l{i + 1}"], params[f"att_r{i + 1}"], graph, k,
                            slope, None if drop is None else drop.attention[i],
                            1.0 if drop is None else drop.att_keep)
        if i < len(heads) - 1:
            h = torch.nn.functional.elu(h)
        elif k > 1:
            h = h.view(h.shape[0], k, -1).mean(1)
    return h


def loss_of(logits: torch.Tensor, truth: torch.Tensor, params: dict,
            weight_decay: float) -> torch.Tensor:
    """Masked mean cross-entropy over the nodes with truth >= 0, plus
    wd/2 · every parameter's squared norm."""
    mask = truth >= 0
    ce = torch.nn.functional.cross_entropy(logits[mask], truth[mask], reduction="mean")
    return ce + 0.5 * weight_decay * sum(torch.sum(p * p) for p in params.values())


def gradients(params: dict, x, graph, truth, heads, slope, weight_decay,
              drop: Dropout | None = None):
    """(loss, logits, {name: gradient}) at ``params``, by autograd."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    logits = forward(leaves, x, graph, heads, slope, drop)
    loss = loss_of(logits, truth, leaves, weight_decay)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), logits.detach(), dict(zip(leaves, grads))


def adam_step(params: dict, m: dict, v: dict, grads: dict, t: int, lr: float) -> None:
    """Step ``t`` (from 1) of the reference program's Adam, in place."""
    step = lr * math.sqrt(1.0 - ADAM_BETA2 ** t) / (1.0 - ADAM_BETA1 ** t)
    for k, g in grads.items():
        m[k].mul_(ADAM_BETA1).add_((1.0 - ADAM_BETA1) * g)
        v[k].mul_(ADAM_BETA2).add_((1.0 - ADAM_BETA2) * g * g)
        params[k].sub_(step * m[k] / (torch.sqrt(v[k]) + ADAM_EPS))


def train_steps(params: dict, x, graph, truth_train, truth_val, heads, slope, weight_decay,
                lr: float, drops: list) -> tuple[list[float], list[float], dict]:
    """One Adam step a ``drops`` entry (its masks, or None): (each step's
    training loss at the weights before it, the validation loss after it,
    the final parameters)."""
    params = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    train, val = [], []
    for t, drop in enumerate(drops, start=1):
        loss, _, grads = gradients(params, x, graph, truth_train, heads, slope, weight_decay,
                                   drop)
        train.append(float(loss))
        adam_step(params, m, v, grads, t, lr)
        with torch.no_grad():
            val.append(float(loss_of(forward(params, x, graph, heads, slope), truth_val,
                                     params, weight_decay)))
    return train, val, params
