"""The Kipf & Welling GCN (cuda_gcn_tpu/models/gcn.py:51-129).

Layer ℓ computes H' = Â · (dropout(H) · Wℓ), ReLU on all but the last layer.
Weights keep the JAX layout and names: ``w1`` [F, H], ``w2`` [H, C], ...
Glorot init is uniform in (-a, a) with a = sqrt(6/(fan_in+fan_out))
(src/seq/variable.cpp:11-18), drawn in f32 from an explicit ``torch.Generator``
and cast to the parameter type (cuda_gcn_tpu/models/gcn.py:51-53). Every
activation takes the type the JAX package gives it: layer 0 on dense x returns
x's type, on sparse x W's type, and each graphsum returns its input's.
"""

from __future__ import annotations

import torch
from torch import nn

from cuda_gcn_torch.data.graph import Graph
from cuda_gcn_torch.ops.dropout import dropout
from cuda_gcn_torch.ops.graphsum import graphsum, graphsum_pair
from cuda_gcn_torch.ops.loss import l2_penalty, masked_cross_entropy, strict_accuracy
from cuda_gcn_torch.ops.matmul import (SparseFeatures, csr_matmul, dense_matmul,
                                       layer0_dense_pair)


def _layer0_transform(x, w, rate, generator, training):
    """dropout(x) @ W for the first layer (cuda_gcn_tpu/models/gcn.py:32-48).
    Dense x (``ops/matmul.layer0_dense_pair``): in training on the card one
    launch of the dense layer-0 kernel, which draws the mask and writes the
    dropped x and the product in one pass; otherwise elementwise dropout and a
    dense product. ``SparseFeatures`` x: dropout on the nnz values (the
    reference's layer-0 dropout, gcn.cpp:23; the same in distribution, since a
    dropped zero stays zero), then the CSR product (reference SparseMatmul,
    module.cpp:47-77)."""
    if isinstance(x, SparseFeatures):
        return csr_matmul(dropout(x.values, rate, generator, training), x, w)
    return layer0_dense_pair(x, w, rate, generator, training)


def layer0_pair(x, w, rate, generator):
    """The fused epoch's first layer: (dropout(x) @ W, x @ W), the second
    without a gradient. Dense x: both from one launch of the dense layer-0
    kernel on the card; ``SparseFeatures`` x: two CSR products."""
    if isinstance(x, SparseFeatures):
        zt = _layer0_transform(x, w, rate, generator, True)
        with torch.no_grad():
            return zt, _layer0_transform(x, w, 0.0, None, False)
    return layer0_dense_pair(x, w, rate, generator, True, with_eval=True)


def glorot(fan_in: int, fan_out: int, generator: torch.Generator,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    a = (6.0 / (fan_in + fan_out)) ** 0.5
    return torch.empty(fan_in, fan_out).uniform_(-a, a, generator=generator).to(dtype)


class GCN(nn.Module):
    def __init__(self, layer_dims: tuple[int, ...], generator: torch.Generator,
                 dtype: torch.dtype = torch.float32):
        """Glorot-initialised weights of ``dtype`` for consecutive
        ``layer_dims`` pairs, drawn on the CPU from ``generator`` (the same
        weights on any device)."""
        super().__init__()
        self.n_layers = len(layer_dims) - 1
        for i in range(self.n_layers):
            setattr(self, f"w{i + 1}", nn.Parameter(
                glorot(layer_dims[i], layer_dims[i + 1], generator, dtype)))

    def weights(self) -> list[torch.Tensor]:
        return [getattr(self, f"w{i + 1}") for i in range(self.n_layers)]

    def forward(self, graph: Graph, x: torch.Tensor | SparseFeatures, *, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None,
                training: bool = False) -> torch.Tensor:
        """Forward pass -> logits [N, C] (``apply`` in the JAX package)."""
        h = x
        for i, w in enumerate(self.weights()):
            if i == 0:
                z = _layer0_transform(h, w, dropout_rate, generator, training)
            else:
                z = dense_matmul(dropout(h, dropout_rate, generator, training), w)
            h = graphsum(z, graph)
            if i < self.n_layers - 1:
                h = torch.relu(h)
        return h

    def apply_pair(self, graph: Graph, x: torch.Tensor, *, dropout_rate: float,
                   generator: torch.Generator | None):
        """One fused forward giving the dropout-active training logits and the
        eval (no-dropout) logits of the same weights: both ride one
        aggregation per layer at concatenated width, and only the training
        half is differentiated (ops/graphsum.graphsum_pair)."""
        for i, w in enumerate(self.weights()):
            if i == 0:
                zt, ze = layer0_pair(x, w, dropout_rate, generator)
            else:
                zt = dense_matmul(dropout(ht, dropout_rate, generator, True), w)
                with torch.no_grad():
                    ze = dense_matmul(he, w)
            ht, he = graphsum_pair(zt, ze, graph)
            if i < self.n_layers - 1:
                ht, he = torch.relu(ht), torch.relu(he)
        return ht, he

    def l2_penalty(self, weight_decay: float) -> torch.Tensor:
        """wd/2·||W1||²: the reference decays layer-1 weights only (gcn.cpp:98-105)."""
        return l2_penalty(self.w1, weight_decay)

    def loss_fn(self, graph: Graph, x: torch.Tensor, truth: torch.Tensor, *,
                weight_decay: float, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None, training: bool = False):
        """Reported loss = masked CE + wd/2·||W1||² (gcn.cpp:112, :98-105);
        returns (loss, logits, accuracy)."""
        logits = self(graph, x, dropout_rate=dropout_rate, generator=generator,
                      training=training)
        loss = masked_cross_entropy(logits, truth) + self.l2_penalty(weight_decay)
        return loss, logits, strict_accuracy(logits, truth)
