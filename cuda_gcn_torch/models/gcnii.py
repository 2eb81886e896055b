"""GCNII (Chen, Wei, Huang, Ding, Li, "Simple and Deep Graph Convolutional
Networks", ICML 2020, arXiv:2007.02133): a deep GCN whose layers keep the
first layer's output (initial residual) and stay close to the identity
(identity mapping), trained by the same entry points as the GCN (train.py).

    h0     = ReLU(dropout(x) · W_in + b_in)                              [N, H]
    s_l    = (1 − α) · Â · dropout(h_{l−1}) + α · h0                       (h_0 = h0)
    h_l    = ReLU(θ_l · s_l · W_l + (1 − θ_l) · s_l),  θ_l = ln(λ/l + 1),  l = 1..L
    logits = dropout(h_L) · W_out + b_out                                [N, C]

Â is the GCN's (self-loops, symmetric normalisation). The semi-supervised
setting of the paper (§6.1, the defaults of its released code's train.py) is
L = 64 layers of H = 64, α = 0.1, λ = 0.5, dropout 0.6, Adam at lr 0.01, L2
0.01 on the convolutions' weights and 5e-4 on the two dense layers';
``GCNConfig`` gives them (``layers``, ``hidden_dim``, ``alpha``, ``lamda``,
``dropout``, ``learning_rate``, ``conv_weight_decay``, ``weight_decay``).

Parameters: ``w_in`` [F, H], ``b_in`` [H], ``w1`` ... ``wL`` [H, H] (the
convolutions, no bias), ``w_out`` [H, C], ``b_out`` [C]. They are drawn on
the CPU from one generator in the released code's order: the convolutions'
weights first, each U(−1/√H, 1/√H), then the dense layers' weight and bias,
each U(−1/√fan_in, 1/√fan_in) (``nn.Linear``'s), each weight drawn as the
[fan_in, fan_out] matrix it is here.

The layer loop is the GCN's (models/gcn.py ``GraphModel``), which hands
layer 0's output to each later layer (``keeps_h0``). Layer 0 is the GCN's
(on dense x in training on the card one launch of the dense layer-0 kernel's
'wide' way for its 64 columns), then the bias and the ReLU (``_layer``). A
convolution aggregates before it multiplies (``_transform``): the initial
residual is one pass of kernel 3's blended form (ops/blend.py), the identity
mapping one ``addmm(s, s, W_l, beta=1−θ_l, alpha=θ_l)``; the fused pair takes
both halves in one blended pass at the concatenated width, then each half's
addmm. On the card the pair's convolution ends instead in one launch of the
epilogue's kernel (ops/epilogue.py): the identity mapping, the ReLU and the
next layer's dropout of both halves, written side by side into the next
blended pass's input; the loop's hooks hand the blended pass on to the next
layer's ``_dropped_pair``, which launches it. The output layer is
``addmm(b_out, dropout(h_L), W_out)``. GCNII runs
on the ``ell`` and ``pallas`` backends (``backends``; 'auto' picks ``ell``),
in float32, on one device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from cuda_gcn_torch.models.gcn import GraphModel
from cuda_gcn_torch.ops.blend import blend, blend_pair
from cuda_gcn_torch.ops.epilogue import fuses, gcnii_epilogue


def theta(lamda: float, layer: int) -> float:
    """θ_l = ln(λ/l + 1) of convolution ``layer`` (1-based)."""
    return math.log(lamda / layer + 1.0)


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(*shape).uniform_(-bound, bound, generator=generator)


class GCNII(GraphModel):
    # kernel 3's blended form walks the ELL plan ('auto' picks the first)
    backends = ("ell", "pallas")
    backends_refusal = "model 'gcnii' aggregates over the ELL plan"
    keeps_h0 = True

    def __init__(self, input_dim: int, hidden: int, classes: int, layers: int,
                 generator: torch.Generator, *, alpha: float = 0.1, lamda: float = 0.5,
                 conv_weight_decay: float = 0.01):
        super().__init__()
        self.n_layers = layers + 2  # the loop's: layer 0, the convolutions, the output layer
        self.alpha, self.lamda, self.conv_weight_decay = alpha, lamda, conv_weight_decay
        self.thetas = tuple(theta(lamda, k) for k in range(1, layers + 1))
        for k in range(1, layers + 1):
            setattr(self, f"w{k}", nn.Parameter(_uniform((hidden, hidden), hidden ** -0.5,
                                                          generator)))
        for name, fan_in, fan_out in (("in", input_dim, hidden), ("out", hidden, classes)):
            setattr(self, f"w_{name}", nn.Parameter(_uniform((fan_in, fan_out), fan_in ** -0.5,
                                                             generator)))
            setattr(self, f"b_{name}", nn.Parameter(_uniform((fan_out,), fan_in ** -0.5,
                                                             generator)))

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator) -> GCNII:
        return cls(cfg.input_dim, cfg.hidden_dim, cfg.output_dim, cfg.layers, generator,
                   alpha=cfg.alpha, lamda=cfg.lamda, conv_weight_decay=cfg.conv_weight_decay)

    def convs(self) -> list[torch.Tensor]:
        return [getattr(self, f"w{k}") for k in range(1, len(self.thetas) + 1)]

    def weights(self) -> list[torch.Tensor]:
        """The loop's weights: W_in, the convolutions' W_1 ... W_L, W_out."""
        return [self.w_in, *self.convs(), self.w_out]

    def _transform(self, i: int, hd, w, h0, graph):
        """Convolution i: the blended aggregation, then the identity mapping;
        the output layer: dropout(h_L) · W_out + b_out."""
        if i > len(self.thetas):
            return torch.addmm(self.b_out, hd, w)
        return self._identity_map(i, blend(hd, h0, graph, 1.0 - self.alpha, self.alpha), w)

    def _transform_pair(self, i: int, hdt, he, w, h0, graph):
        """Convolution i of both halves: one blended pass at the concatenated
        width, then each half's identity mapping (the evaluation half's
        without a gradient); where the epilogue's kernels take the pass, the
        pass alone (its identity mapping is the epilogue's, ``_dropped_pair``)."""
        if i > len(self.thetas):
            return super()._transform_pair(i, hdt, he, w, h0, graph)
        st, se = blend_pair(hdt, he, *h0, graph, 1.0 - self.alpha, self.alpha)
        if fuses(st):
            return st, se
        zt = self._identity_map(i, st, w)
        with torch.no_grad():
            return zt, self._identity_map(i, se, w)

    def _dropped_pair(self, i: int, ht, he, rate: float, generator):
        """Layer i's input pair. After a convolution whose blended pass the
        epilogue's kernels take (``ht``, ``he``: that pass), one launch of the
        epilogue: the convolution's identity mapping, its ReLU and this
        layer's dropout, both halves side by side in the next blended pass's
        input (apart for the output layer). Else dropout(h_t), h_e."""
        if i < 2 or not fuses(ht):
            return super()._dropped_pair(i, ht, he, rate, generator)
        return gcnii_epilogue(ht, he, getattr(self, f"w{i - 1}"), self.thetas[i - 2], rate,
                              generator, concat=i <= len(self.thetas))

    def _identity_map(self, i: int, s, w):
        t = self.thetas[i - 1]
        return torch.addmm(s, s, w, beta=1.0 - t, alpha=t)

    def _layer(self, i: int, z, graph, graphsums, generator, training: bool):
        """Layer 0: bias and ReLU; a convolution: ReLU; the output layer: z."""
        if i == 0:
            return torch.relu(z + self.b_in)
        return torch.relu(z) if i <= len(self.thetas) else z

    def _layer_pair(self, i: int, zt, ze, graph, graphsums, generator):
        """As ``_layer`` a half; a convolution whose blended pass the
        epilogue's kernels take hands the pass on whole (``_dropped_pair``)."""
        if 1 <= i <= len(self.thetas) and fuses(zt):
            return zt, ze
        return super()._layer_pair(i, zt, ze, graph, graphsums, generator)

    def l2_penalty(self, weight_decay: float) -> torch.Tensor:
        """conv_weight_decay/2 · Σ_l ||W_l||² + weight_decay/2 · (||W_in||² +
        ||b_in||² + ||W_out||² + ||b_out||²): the released code's coupled
        decay in torch's Adam (two parameter groups), as a loss term. The
        convolutions' squares are summed as one stacked tensor: a few launches,
        not a few a layer."""
        conv = torch.sum(torch.square(torch.stack(self.convs())))
        dense = sum(torch.sum(torch.square(p)) for p in (self.w_in, self.b_in, self.w_out,
                                                         self.b_out))
        return 0.5 * self.conv_weight_decay * conv + 0.5 * weight_decay * dense
