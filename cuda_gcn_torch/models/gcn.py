"""The Kipf & Welling GCN (cuda_gcn_tpu/models/gcn.py:51-129).

Layer ℓ computes H' = Â · (dropout(H) · Wℓ), ReLU on all but the last layer.
Weights keep the JAX layout and names: ``w1`` [F, H], ``w2`` [H, C], ...
Glorot init is uniform in (-a, a) with a = sqrt(6/(fan_in+fan_out))
(src/seq/variable.cpp:11-18), drawn in f32 from an explicit ``torch.Generator``
and cast to the parameter type (cuda_gcn_tpu/models/gcn.py:51-53). Every
activation takes the type the JAX package gives it: layer 0 on dense x returns
x's type, on sparse x W's type, and each graphsum returns its input's.

``GraphModel`` holds the layer loop and the loss that the GCN, the GAT
(models/gat.py) and GCNII (models/gcnii.py) share, and resolves a model's
graph backend (``graph_backend``); the GCN adds the Â-sum and the ReLU after
each layer's product. The sharded trainer (parallel/sharded.py) runs the same
loop with its halo sums in the Â-sum's place, for the models that declare
they shard (``shards``).
"""

from __future__ import annotations

import torch
from torch import nn

from cuda_gcn_torch.data.graph import DENSE_BACKEND_MAX_NODES
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


GRAPHSUMS = (graphsum, graphsum_pair)  # a ``Graph``'s Â-sums: (single, pair)


class GraphModel(nn.Module):
    """The layer loop (single and fused pair) and the loss of every model.
    Layer 0 is ``_layer0_transform`` / ``layer0_pair``, every other layer
    the hook ``_transform`` of dropout(h) (by default ``dense_matmul(dropout(h),
    W)``; ``_transform_pair`` the pair's, by default the halves apart, the
    evaluation half's without a gradient, of the pair that ``_dropped_pair``
    makes of the previous layer's output, by default dropout(h_t) and h_e as
    it is); a model's hooks ``_layer`` and
    ``_layer_pair`` (by default the halves apart, the evaluation half without
    dropout or gradient) turn the product into the layer's output, with the
    caller's Â-sums ``graphsums`` (single, pair). Where a model ``keeps_h0``,
    the loop hands layer 0's output (the pair's: both halves) to every later
    ``_transform``; else None. A model declares the graph ``backends`` it runs
    on (None: all), whether it ``needs_edge_map`` (the graph's reverse-edge
    map) and whether the sharded trainer takes it (``shards``)."""

    backends: tuple[str, ...] | None = None
    backends_refusal = ""
    needs_edge_map = False
    keeps_h0 = False
    shards = False

    @classmethod
    def graph_backend(cls, backend: str, n_nodes: int) -> str:
        """``backend`` for this model on ``n_nodes`` nodes (a graph or a part's
        block): 'auto' is the first of ``backends``, else 'dense' up to
        ``DENSE_BACKEND_MAX_NODES`` nodes and 'bsr' above; others are refused."""
        if backend == "auto":
            if cls.backends:
                return cls.backends[0]
            return "dense" if n_nodes <= DENSE_BACKEND_MAX_NODES else "bsr"
        if cls.backends and backend not in cls.backends:
            raise ValueError(f"{cls.backends_refusal}: graphsum_backend "
                             f"{' or '.join(map(repr, cls.backends))}, got {backend!r}")
        return backend

    def weights(self) -> list[torch.Tensor]:
        return [getattr(self, f"w{i + 1}") for i in range(self.n_layers)]

    def forward(self, graph, x: torch.Tensor | SparseFeatures, *, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None, training: bool = False,
                graphsums=GRAPHSUMS) -> torch.Tensor:
        """Forward pass -> logits [N, C] (``apply`` in the JAX package)."""
        h, h0 = x, None
        for i, w in enumerate(self.weights()):
            if i == 0:
                z = _layer0_transform(h, w, dropout_rate, generator, training)
            else:
                z = self._transform(i, dropout(h, dropout_rate, generator, training), w, h0,
                                    graph)
            h = self._layer(i, z, graph, graphsums, generator, training)
            if i == 0 and self.keeps_h0:
                h0 = h
        return h

    def apply_pair(self, graph, x: torch.Tensor | SparseFeatures, *, dropout_rate: float,
                   generator: torch.Generator | None, graphsums=GRAPHSUMS):
        """One fused forward giving the dropout-active training logits and the
        evaluation (no-dropout) logits of the same weights; only the training
        half is differentiated."""
        h0 = None
        for i, w in enumerate(self.weights()):
            if i == 0:
                zt, ze = layer0_pair(x, w, dropout_rate, generator)
            else:
                hd, he = self._dropped_pair(i, ht, he, dropout_rate, generator)
                del ht  # no hook reads it: the GAT's ELU output is not held through both halves
                zt, ze = self._transform_pair(i, hd, he, w, h0, graph)
            ht, he = self._layer_pair(i, zt, ze, graph, graphsums, generator)
            if i == 0 and self.keeps_h0:
                h0 = (ht, he)
        return ht, he

    def _dropped_pair(self, i: int, ht, he, rate: float, generator):
        """Layer i's input pair from layer i − 1's output pair: the training
        half dropped out, the evaluation half as it is."""
        return dropout(ht, rate, generator, True), he

    def _transform(self, i: int, hd, w, h0, graph):
        """Layer i's product of its dropped-out input ``hd``."""
        return dense_matmul(hd, w)

    def _transform_pair(self, i: int, hdt, he, w, h0, graph):
        """The pair's products: the training half's of its dropped-out input
        ``hdt``, then the evaluation half's, without a gradient."""
        zt = self._transform(i, hdt, w, None if h0 is None else h0[0], graph)
        with torch.no_grad():
            ze = self._transform(i, he, w, None if h0 is None else h0[1], graph)
        return zt, ze

    def _layer_pair(self, i: int, zt, ze, graph, graphsums, generator):
        ht = self._layer(i, zt, graph, graphsums, generator, True)
        with torch.no_grad():
            he = self._layer(i, ze, graph, graphsums, None, False)
        return ht, he

    def loss_fn(self, graph, x: torch.Tensor | SparseFeatures, truth: torch.Tensor, *,
                weight_decay: float, dropout_rate: float = 0.0,
                generator: torch.Generator | None = None, training: bool = False):
        """(masked CE + ``l2_penalty``, logits, accuracy) (gcn.cpp:112)."""
        logits = self(graph, x, dropout_rate=dropout_rate, generator=generator,
                      training=training)
        loss = masked_cross_entropy(logits, truth) + self.l2_penalty(weight_decay)
        return loss, logits, strict_accuracy(logits, truth)


class GCN(GraphModel):
    shards = True  # the sharded trainer runs its loop with halo sums

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

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator) -> GCN:
        return cls(cfg.layer_dims(), generator, getattr(torch, cfg.param_dtype))

    def _layer(self, i: int, z, graph, graphsums, generator, training: bool):
        """Â-sum, then ReLU on all but the last layer."""
        h = graphsums[0](z, graph)
        return torch.relu(h) if i < self.n_layers - 1 else h

    def _layer_pair(self, i: int, zt, ze, graph, graphsums, generator):
        """Both halves' Â-sums in one pass at the concatenated width
        (ops/graphsum.graphsum_pair), then ReLU on all but the last layer."""
        ht, he = graphsums[1](zt, ze, graph)
        if i < self.n_layers - 1:
            ht, he = torch.relu(ht), torch.relu(he)
        return ht, he

    def l2_penalty(self, weight_decay: float) -> torch.Tensor:
        """wd/2·||W1||²: the reference decays layer-1 weights only (gcn.cpp:98-105)."""
        return l2_penalty(self.w1, weight_decay)
