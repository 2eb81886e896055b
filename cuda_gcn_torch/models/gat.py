"""The graph attention network (GAT; Veličković et al., "Graph Attention
Networks", ICLR 2018, arXiv:1710.10903), trained by the same entry points as
the GCN (train.py).

Layer ℓ with K heads of F' features: z = dropout(h) · Wℓ [N, K·F'], the
scores sl = ⟨z_i,k, a_l,k⟩ and sr = ⟨z_j,k, a_r,k⟩ of each head, and the
attention over Â's rows (self-loops included; ops/attention.py), its weights
LeakyReLU'd, normalised by a softmax over each row and dropped out. A hidden
layer concatenates its heads and applies ELU; the output layer averages its
heads (eq. 6). The transductive setting of §3.3 is 8 heads of 8 features,
one output head, LeakyReLU slope 0.2 and dropout 0.6 on both layers' inputs
and on the weights; ``GCNConfig`` gives them (``layer_heads``,
``attention_dropout``, ``leaky_slope``, ``dropout``).

Weights: ``w1`` [F, K1·F1'], ``w2`` [K1·F1', K2·C], ... and each layer's
attention vectors ``att_l1``, ``att_r1`` [K1, F1'], ... , all Glorot uniform
(models/gcn.py ``glorot``: a [K, F'] vector as a matrix of that shape),
drawn on the CPU from one generator in that order, layer by layer. There are
no biases, as in the paper's equations. The L2 term of the loss covers every
weight and attention vector (``l2_penalty``; the paper does not say which).

Layer 0 is the GCN's (models/gcn.py ``_layer0_transform``, ``layer0_pair``):
on dense x in training on the card one launch of the dense layer-0 kernel a
16 output columns, which draws the input's dropout and writes the pair.
"""

from __future__ import annotations

import torch
from torch import nn

from cuda_gcn_torch.data.graph import Graph
from cuda_gcn_torch.models.gcn import _layer0_transform, glorot, layer0_pair
from cuda_gcn_torch.ops.attention import attention
from cuda_gcn_torch.ops.dropout import dropout
from cuda_gcn_torch.ops.loss import masked_cross_entropy, strict_accuracy
from cuda_gcn_torch.ops.matmul import SparseFeatures, dense_matmul


class GAT(nn.Module):
    def __init__(self, layer_dims: tuple[int, ...], heads: tuple[int, ...],
                 generator: torch.Generator, dtype: torch.dtype = torch.float32, *,
                 attention_dropout: float = 0.6, leaky_slope: float = 0.2):
        """``layer_dims`` (F, F1', ..., C): the input width, each hidden
        layer's features a head and the classes; ``heads`` (K1, ..., K_out)."""
        super().__init__()
        if len(heads) != len(layer_dims) - 1:
            raise ValueError(f"heads {heads} do not give each of {len(layer_dims) - 1} layers")
        self.n_layers = len(heads)
        self.heads = tuple(heads)
        self.attention_dropout, self.leaky_slope = attention_dropout, leaky_slope
        fan_in = layer_dims[0]
        for i, k in enumerate(self.heads):
            fh = layer_dims[i + 1]
            setattr(self, f"w{i + 1}", nn.Parameter(glorot(fan_in, k * fh, generator, dtype)))
            setattr(self, f"att_l{i + 1}", nn.Parameter(glorot(k, fh, generator, dtype)))
            setattr(self, f"att_r{i + 1}", nn.Parameter(glorot(k, fh, generator, dtype)))
            fan_in = k * fh

    def weights(self) -> list[torch.Tensor]:
        return [getattr(self, f"w{i + 1}") for i in range(self.n_layers)]

    def _attend(self, i: int, z: torch.Tensor, graph: Graph, generator, training: bool):
        """Layer i's attention over z, then ELU (hidden) or the heads' mean
        (output)."""
        k = self.heads[i]
        z3 = z.view(z.shape[0], k, -1)
        sl = (z3 * getattr(self, f"att_l{i + 1}")).sum(-1)
        sr = (z3 * getattr(self, f"att_r{i + 1}")).sum(-1)
        h = attention(z, sl, sr, graph.edge_map, k, self.leaky_slope, self.attention_dropout,
                      generator, training)
        if i < self.n_layers - 1:
            return nn.functional.elu(h)
        return h if k == 1 else h.view(h.shape[0], k, -1).mean(1)

    def forward(self, graph: Graph, x: torch.Tensor | SparseFeatures, *,
                dropout_rate: float = 0.0, generator: torch.Generator | None = None,
                training: bool = False) -> torch.Tensor:
        """Forward pass -> logits [N, C]."""
        h = x
        for i, w in enumerate(self.weights()):
            if i == 0:
                z = _layer0_transform(h, w, dropout_rate, generator, training)
            else:
                z = dense_matmul(dropout(h, dropout_rate, generator, training), w)
            h = self._attend(i, z, graph, generator, training)
        return h

    def apply_pair(self, graph: Graph, x: torch.Tensor, *, dropout_rate: float,
                   generator: torch.Generator | None):
        """The fused epoch's pair: the dropout-active training logits and the
        evaluation logits of the same weights. Layer 0's two products come
        from one pass over x; the attention takes each half apart (their
        weights differ), the evaluation half without dropout or gradient."""
        for i, w in enumerate(self.weights()):
            if i == 0:
                zt, ze = layer0_pair(x, w, dropout_rate, generator)
            else:
                zt = dense_matmul(dropout(ht, dropout_rate, generator, True), w)
                with torch.no_grad():
                    ze = dense_matmul(he, w)
            ht = self._attend(i, zt, graph, generator, True)
            with torch.no_grad():
                he = self._attend(i, ze, graph, None, False)
        return ht, he

    def l2_penalty(self, weight_decay: float) -> torch.Tensor:
        """weight_decay/2 · the squared norm of every weight and attention vector."""
        return 0.5 * weight_decay * sum(torch.sum(torch.square(p.float()))
                                        for p in self.parameters())

    def loss_fn(self, graph: Graph, x: torch.Tensor, truth: torch.Tensor, *,
                weight_decay: float, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None, training: bool = False):
        """(masked CE + ``l2_penalty``, logits, accuracy)."""
        logits = self(graph, x, dropout_rate=dropout_rate, generator=generator,
                      training=training)
        loss = masked_cross_entropy(logits, truth) + self.l2_penalty(weight_decay)
        return loss, logits, strict_accuracy(logits, truth)
