"""Hyperparameter configuration (PyTorch port).

A copy of ``GCNConfig`` from the JAX package (cuda_gcn_tpu/config.py:19-57) with
the same fields and defaults, so the same config means the same run in both
packages. The port keeps its own copy because it imports nothing of the JAX
package. ``feature_matmul`` selects dense or sparse (CSR) layer-0 features.
``compute_dtype`` (activations and features), ``param_dtype`` (weights) and
``halo_dtype`` (the wire type of the sharded trainer's halo rows,
parallel/sharded.py) are each 'float32' or 'bfloat16'; another value is
refused here, by name.

``model`` picks the network: 'gcn' (models/gcn.py, the default and the JAX
package's only model), 'gat' (models/gat.py, Veličković et al.'s graph
attention network, arXiv:1710.10903) or 'gcnii' (models/gcnii.py, Chen et
al.'s deep GCN with initial residual and identity mapping,
arXiv:2007.02133). The GAT reads ``hidden_dims`` (or
``hidden_dim``) as the features of one head, ``heads`` as the heads of each
layer (default: 8 on every hidden layer, 1 on the output layer; the hidden
layers concatenate their heads, the output layer averages them),
``attention_dropout`` as the dropout on the normalised attention weights
and ``leaky_slope`` as the LeakyReLU's slope of the edge scores; the GCN reads
none of them. GCNII reads ``hidden_dim`` as the width of every layer
between its two dense layers, ``layers`` as its depth (the convolutions
between them), ``alpha`` as the initial residual's share α, ``lamda`` as the
λ of the identity mapping's θ_l = ln(λ/l + 1), and ``conv_weight_decay`` as
the L2 of its convolutions' weights beside ``weight_decay``, that of the two
dense layers; the other models read none of them. The JAX package's
``GCNConfig`` has the other fields only (``MODEL_FIELDS`` are the port's). An
unknown model is refused by name, and so is a GAT or a GCNII outside float32
(the attention kernels and kernel 3's blended form are f32), a GAT with a
head count a layer does not have, and a GCNII given ``hidden_dims`` (its
layers are of one width), fewer than one layer, α outside [0, 1] or λ not
above 0.
"""

from __future__ import annotations

import dataclasses

DTYPES = ("float32", "bfloat16")
MODELS = ("gcn", "gat", "gcnii")
# The fields the JAX package's config does not have: the model's name, the
# GAT's and GCNII's.
GAT_FIELDS = ("model", "heads", "attention_dropout", "leaky_slope")
MODEL_FIELDS = GAT_FIELDS + ("layers", "alpha", "lamda", "conv_weight_decay")
# The GAT's heads on each hidden layer where ``heads`` is None (the paper's
# transductive setting, §3.3); the output layer has one.
GAT_HIDDEN_HEADS = 8


@dataclasses.dataclass
class GCNConfig:
    """Hyperparameters for a full-batch GCN training run.

    Defaults mirror the reference ``GCNParams::get_default()``
    (src/seq/gcn.cpp:9-11): ``{2708, 1433, 16, 7, 0.5, 0.01, 5e-4, 100, 0}``.
    ``num_nodes``/``input_dim``/``output_dim`` are overwritten by the dataset.
    """

    num_nodes: int = 2708
    input_dim: int = 1433
    hidden_dim: int = 16
    output_dim: int = 7
    dropout: float = 0.5
    learning_rate: float = 0.01
    weight_decay: float = 5e-4
    epochs: int = 100
    early_stopping: int = 0

    seed: int = 0
    hidden_dims: tuple[int, ...] | None = None
    graphsum_backend: str = "auto"     # 'auto' | 'segment' | 'ell' | 'pallas' | 'dense' | 'bsr'
    reorder: str = "auto"              # 'auto' | 'none'
    feature_matmul: str = "dense"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    halo_dtype: str = "bfloat16"
    bsr_budget_gb: float | None = None
    model: str = "gcn"
    heads: tuple[int, ...] | None = None
    attention_dropout: float = 0.6
    leaky_slope: float = 0.2
    layers: int = 64
    alpha: float = 0.1
    lamda: float = 0.5
    conv_weight_decay: float = 0.01

    def __post_init__(self):
        for field in ("compute_dtype", "param_dtype", "halo_dtype"):
            if getattr(self, field) not in DTYPES:
                raise ValueError(f"{field} must be one of {DTYPES}, got "
                                 f"{getattr(self, field)!r}")
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, got {self.model!r}")
        if self.model != "gcn" and (self.compute_dtype != "float32"
                                    or self.param_dtype != "float32"):
            raise ValueError(f"model {self.model!r} runs in float32 (compute_dtype and "
                             f"param_dtype)")
        if self.model == "gat":
            self.layer_heads()
        if self.model == "gcnii":
            if self.hidden_dims is not None:
                raise ValueError("model 'gcnii' takes its width from hidden_dim and its depth "
                                 f"from layers, got hidden_dims {self.hidden_dims!r}")
            if self.layers < 1 or not 0.0 <= self.alpha <= 1.0 or not self.lamda > 0.0:
                raise ValueError(f"model 'gcnii' needs layers >= 1, 0 <= alpha <= 1 and "
                                 f"lamda > 0, got layers {self.layers!r}, alpha "
                                 f"{self.alpha!r}, lamda {self.lamda!r}")

    def layer_heads(self) -> tuple[int, ...]:
        """The GAT's heads of each layer: ``heads``, else ``GAT_HIDDEN_HEADS`` on
        every hidden layer and one on the output layer."""
        n_layers = len(self.layer_dims()) - 1
        heads = self.heads if self.heads is not None else \
            (GAT_HIDDEN_HEADS,) * (n_layers - 1) + (1,)
        heads = tuple(int(k) for k in heads)
        if len(heads) != n_layers or min(heads) < 1:
            raise ValueError(f"heads must give each of the {n_layers} layers at least one "
                             f"head, got {self.heads!r}")
        return heads

    def layer_dims(self) -> tuple[int, ...]:
        hidden = self.hidden_dims if self.hidden_dims is not None else (self.hidden_dim,)
        return (self.input_dim, *hidden, self.output_dim)


def default_config() -> GCNConfig:
    return GCNConfig()
