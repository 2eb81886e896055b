"""Checkpoints in the JAX package's npz layout (cuda_gcn_tpu/utils/checkpoint.py).

The JAX package saves the leaves of its ``TrainState`` in flattening order as
``leaf_0`` … ``leaf_{k-1}``: the weights by name (``w1``, ``w2``, ...), Adam's
``m`` and ``v`` by name, the int32 step, and the uint32[2] PRNG key
(cuda_gcn_tpu/train.py:44-56, ops/adam.py:40-50). The port writes and reads
exactly that, so a checkpoint of either package loads in the other: weights
and moments keep their types through convert.py (f32 as f32, bf16 as the raw
2-byte records of the JAX package's file, bit for bit).

The key's two words carry the dropout generator. On the card it is Philox,
and the words are its seed and offset, so a restored run draws the masks the
uninterrupted run would have drawn. The CPU generator's state is no two words:
there the first word is a CRC-32 of its state and restoring only reseeds it.
A JAX key reseeds the port's generator: the two packages' dropout streams
differ by design.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from cuda_gcn_torch import convert

_WORD = 1 << 32


def _leaves(state) -> list[torch.Tensor]:
    """The tensors of ``state`` in the JAX flattening order, the key last as
    a placeholder of its shape."""
    params = dict(state.model.named_parameters())
    return ([params[k] for k in sorted(params)] + [state.opt.m[k] for k in sorted(state.opt.m)]
            + [state.opt.v[k] for k in sorted(state.opt.v)]
            + [state.opt.step, torch.zeros(2, dtype=torch.int64)])


def _key_words(gen: torch.Generator) -> np.ndarray:
    if gen.device.type == "cuda":
        words = {"seed": gen.initial_seed(), "offset": gen.get_offset()}
        for what, v in words.items():
            if not 0 <= v < _WORD:
                raise ValueError(f"the dropout generator's {what} {v} does not fit the "
                                 f"checkpoint's 32-bit key word")
        return np.array(list(words.values()), dtype=np.uint32)
    return np.array([zlib.crc32(gen.get_state().numpy().tobytes()), 0], dtype=np.uint32)


def _set_key(gen: torch.Generator, words: np.ndarray) -> None:
    lo, hi = (int(w) for w in words)
    if gen.device.type == "cuda":
        gen.manual_seed(lo)
        # Philox offsets advance in steps of 4: the port's own word comes back
        # exactly; a JAX key's second word is rounded down to a step
        gen.set_offset(hi - hi % 4)
    else:
        gen.manual_seed(hi * _WORD + lo)


def save_state(path: str, state) -> None:
    """Write ``state`` (train.TrainState) to ``path`` as the JAX package does."""
    leaves = [convert.tensor_to_jax(t) for t in _leaves(state)[:-1]]
    leaves[-1] = leaves[-1].astype(np.int32)  # the step
    leaves.append(_key_words(state.generator))
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(leaves)})


def restore_state(path: str, like):
    """Load a checkpoint of either package into ``like`` (a TrainState of the
    same layer sizes, e.g. from train.create_state) and return it. Each array
    takes the type of its place in ``like``."""
    with np.load(path) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    template = _leaves(like)
    if len(template) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves but template has {len(template)}")
    for t, a in zip(template, arrays):
        if tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"leaf shape mismatch: checkpoint {a.shape} vs template "
                             f"{tuple(t.shape)}")
    with torch.no_grad():
        for t, a in zip(template[:-1], arrays[:-1]):
            t.copy_(convert.tensor_from_jax(a, t.device).to(t.dtype))
    _set_key(like.generator, arrays[-1])
    return like
