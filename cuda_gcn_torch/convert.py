"""Load JAX-package weights and Adam moments into the port.

The JAX package keeps parameters as ``{'w1': [F, H], 'w2': [H, C], ...}``
(cuda_gcn_tpu/models/gcn.py ``init_params``) and Adam as ``m``/``v`` trees of
the same shape plus an int32 ``step`` (cuda_gcn_tpu/ops/adam.py). Given those
as numpy arrays, these functions build the port's state, so that both packages
compute the same thing from the same weights. Every array keeps its type: f32
stays f32, and a bf16 array (``param_dtype='bfloat16'``), which JAX hands over
as an ``ml_dtypes.bfloat16`` numpy array, comes across bit for bit through a
16-bit integer view, so the port needs no ``ml_dtypes``. An npz file keeps
such an array as raw 2-byte records (``|V2``), which are read the same way,
and ``tensor_to_jax`` writes a bf16 tensor in that form.
"""

from __future__ import annotations

import numpy as np
import torch

from cuda_gcn_torch.ops.adam import AdamState

# how an npz file holds a bf16 array of the JAX package (ml_dtypes' bfloat16)
_RAW_BF16 = np.dtype("V2")


def tensor_from_jax(a, device: str | torch.device) -> torch.Tensor:
    """One array of the JAX package as a tensor of the same type and bits."""
    a = np.array(a)  # a copy: the tensor owns its memory
    if a.dtype.name == "bfloat16" or a.dtype == _RAW_BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_jax(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array ``np.savez`` gets from the JAX package: its
    type kept, bf16 as raw 2-byte records of the same bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_RAW_BF16)
    return t.numpy()


def params_from_jax(params: dict[str, np.ndarray],
                    device: str | torch.device) -> dict[str, torch.Tensor]:
    """A ``GCN`` state_dict from ``TrainState.params`` (same names, layout and
    types)."""
    return {k: tensor_from_jax(v, device) for k, v in params.items()}


def adam_from_jax(m: dict[str, np.ndarray], v: dict[str, np.ndarray], step: int,
                  device: str | torch.device) -> AdamState:
    return AdamState(m=params_from_jax(m, device), v=params_from_jax(v, device),
                     step=torch.tensor(int(step), dtype=torch.int32, device=device))
