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

The layer loop, layer 0 and the loss are the GCN's (models/gcn.py
``GraphModel``); the GAT adds its attention after each layer's product
(``_layer``). A layer whose F' is no multiple of 4 (the output layer's 41
classes) multiplies by its weight zero-padded per head to LD =
``head_stride(F')`` columns (``weights``; the parameter keeps its shape), so
that z, out and their gradients hold each head at 16-byte-aligned rows and the
attention kernels load them as float4; the scores read z without the padding,
and the layer's output leaves it out. On dense x in training on the card layer 0 is one launch of the
dense layer-0 kernel's 'wide' way for its 64 output columns (8 heads of 8),
which draws the input's dropout and writes the pair. The GAT runs on the
``ell`` and ``pallas`` backends (``backends``; 'auto' picks ``ell``) and reads
the graph's reverse-edge map (``needs_edge_map``), which train.prepare builds.
"""

from __future__ import annotations

import torch
from torch import nn

from cuda_gcn_torch.data.graph import Graph
from cuda_gcn_torch.models.gcn import GraphModel, glorot
from cuda_gcn_torch.ops.attention import attention, head_stride


class GAT(GraphModel):
    # the attention kernels walk the ELL plan ('auto' picks the first)
    backends = ("ell", "pallas")
    backends_refusal = "model 'gat' attends over the ELL plan"
    needs_edge_map = True

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

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator) -> GAT:
        return cls(cfg.layer_dims(), cfg.layer_heads(), generator,
                   getattr(torch, cfg.param_dtype), attention_dropout=cfg.attention_dropout,
                   leaky_slope=cfg.leaky_slope)

    def weights(self) -> list[torch.Tensor]:
        """Each layer's weight [F_in, K·LD] as the layer loop multiplies by it:
        the parameter [F_in, K·F'] with each head's columns padded by zeros to
        LD = ``head_stride(F')`` (the parameter itself where LD = F')."""
        out = []
        for i, k in enumerate(self.heads):
            w = getattr(self, f"w{i + 1}")
            fh = w.shape[1] // k
            if head_stride(fh) != fh:
                w = nn.functional.pad(w.view(w.shape[0], k, fh), (0, head_stride(fh) - fh))
                w = w.view(w.shape[0], -1)
            out.append(w)
        return out

    def _layer(self, i: int, z: torch.Tensor, graph: Graph, graphsums, generator,
               training: bool):
        """Layer i's attention over z [N, K·LD], then ELU (hidden) or the
        heads' mean (output), of each head's F' features; no Â-sum. The pair
        takes each half apart (their attention weights differ)."""
        k, a_l = self.heads[i], getattr(self, f"att_l{i + 1}")
        n, fh = z.shape[0], a_l.shape[1]
        z3 = z.view(n, k, -1)[..., :fh]
        sl = (z3 * a_l).sum(-1)
        sr = (z3 * getattr(self, f"att_r{i + 1}")).sum(-1)
        h = attention(z, sl, sr, graph.edge_map, k, self.leaky_slope, self.attention_dropout,
                      generator, training, fh=fh).view(n, k, -1)[..., :fh]
        if i < self.n_layers - 1:
            return nn.functional.elu(h).reshape(n, k * fh)
        # the logits in rows of their own: a view would hold the padded out
        # (and the evaluation half's) for the rest of the step
        return (h[:, 0] if k == 1 else h.mean(1)).contiguous()

    def l2_penalty(self, weight_decay: float) -> torch.Tensor:
        """weight_decay/2 · the squared norm of every weight and attention vector."""
        return 0.5 * weight_decay * sum(torch.sum(torch.square(p.float()))
                                        for p in self.parameters())
