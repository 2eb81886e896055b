"""Hyperparameter configuration (PyTorch port).

A copy of ``GCNConfig`` from the JAX package (cuda_gcn_tpu/config.py:19-57) with
the same fields and defaults, so the same config means the same run in both
packages. The port keeps its own copy because it imports nothing of the JAX
package. ``feature_matmul`` selects dense or sparse (CSR) layer-0 features.
``compute_dtype`` (activations and features), ``param_dtype`` (weights) and
``halo_dtype`` (the wire type of the sharded trainer's halo rows,
parallel/sharded.py) are each 'float32' or 'bfloat16'; another value is
refused here, by name.
"""

from __future__ import annotations

import dataclasses

DTYPES = ("float32", "bfloat16")


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

    def __post_init__(self):
        for field in ("compute_dtype", "param_dtype", "halo_dtype"):
            if getattr(self, field) not in DTYPES:
                raise ValueError(f"{field} must be one of {DTYPES}, got "
                                 f"{getattr(self, field)!r}")

    def layer_dims(self) -> tuple[int, ...]:
        hidden = self.hidden_dims if self.hidden_dims is not None else (self.hidden_dim,)
        return (self.input_dim, *hidden, self.output_dim)


def default_config() -> GCNConfig:
    return GCNConfig()
