"""Checkpoints: the port writes and reads the JAX package's npz layout.

Eight leaves ``leaf_0`` … ``leaf_7`` (w1, w2, Adam m and v of each, the int32
step, the uint32[2] key), so a checkpoint of either package loads in the
other, every weight and moment bit for bit. A bf16 weight is held in the file
as the JAX package holds it (raw 2-byte records), and the JAX package's own
bf16 file loads into the port without ml_dtypes. On the CPU the dropout
generator is only reseeded by the key, so 2 + 2 epochs equal 4 at dropout 0;
on the card the key carries Philox's seed and offset, and chip_smoke.py (o)
holds 2 + 2 against 4 at dropout 0.5.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.utils import checkpoint as jckpt

from cuda_gcn_torch import train as ttrain
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.utils import checkpoint as tckpt
from test_torch_train import to_torch_dataset

KW = dict(epochs=2, seed=1, graphsum_backend="segment")


def _bits(a) -> np.ndarray:
    """An array's bits, whatever its type (bf16 included)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().copy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind in "fV" else a


def _port_leaves(state) -> list:
    return tckpt._leaves(state)[:-1] + [tckpt._key_words(state.generator)]


def _trained_port_state(ds, param_dtype="float32"):
    """A port state after two epochs: moments and step are not their zeros."""
    cfg = GCNConfig(**KW, param_dtype=param_dtype)
    return ttrain.run(cfg, to_torch_dataset(ds), device="cpu", verbose=False).state


def _trained_jax_state(ds, param_dtype="float32"):
    cfg = JConfig(**KW, param_dtype=param_dtype)
    return jtrain.run(cfg, ds, verbose=False).state


def _template(ds, param_dtype="float32", **kw):
    cfg = to_torch_dataset(ds).apply_config(GCNConfig(**KW, param_dtype=param_dtype, **kw))
    return ttrain.create_state(cfg, "cpu")


def test_port_checkpoint_loads_in_jax(tiny_dataset, tmp_path):
    state = _trained_port_state(tiny_dataset)
    path = str(tmp_path / "port.npz")
    tckpt.save_state(path, state)
    with np.load(path) as z:
        assert sorted(z.files) == [f"leaf_{i}" for i in range(8)]
    like = jtrain.create_state(tiny_dataset.apply_config(JConfig(**KW)))
    restored = jax.tree_util.tree_leaves(jckpt.restore_state(path, like=like))
    want = _port_leaves(state)
    assert len(restored) == len(want) == 8
    for got, w in zip(restored, want):
        assert np.asarray(got).dtype == _bits(w).dtype
        np.testing.assert_array_equal(_bits(got), _bits(w))
    assert int(restored[6]) == 2


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_loads_in_the_port(tiny_dataset, tmp_path, param_dtype):
    """Every leaf of the JAX package's file, f32 or bf16 weights, bit for bit;
    its key reseeds the port's generator."""
    jstate = _trained_jax_state(tiny_dataset, param_dtype)
    path = str(tmp_path / "jax.npz")
    jckpt.save_state(path, jstate)
    state = tckpt.restore_state(path, like=_template(tiny_dataset, param_dtype))
    want = jax.tree_util.tree_leaves(jstate)
    got = _port_leaves(state)
    assert state.model.w1.dtype == getattr(torch, param_dtype)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    lo, hi = (int(v) for v in np.asarray(want[-1]))
    assert state.generator.initial_seed() == (hi << 32) | lo


def test_port_bf16_checkpoint_round_trips(tiny_dataset, tmp_path):
    state = _trained_port_state(tiny_dataset, "bfloat16")
    path = str(tmp_path / "bf16.npz")
    tckpt.save_state(path, state)
    with np.load(path) as z:
        assert z["leaf_0"].dtype.str == z["leaf_1"].dtype.str == "|V2"
        assert z["leaf_2"].dtype == np.float32 and z["leaf_6"].dtype == np.int32
        assert z["leaf_7"].dtype == np.uint32 and z["leaf_7"].shape == (2,)
    restored = tckpt.restore_state(path, like=_template(tiny_dataset, "bfloat16"))
    for g, w in zip(_port_leaves(restored)[:-1], _port_leaves(state)[:-1]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("fault", ["extra leaf", "missing leaf", "shape"])
def test_a_checkpoint_that_does_not_fit_raises(tiny_dataset, tmp_path, fault):
    """The JAX function's checks and messages: the leaf count, then each shape."""
    path = str(tmp_path / "c.npz")
    tckpt.save_state(path, _template(tiny_dataset))
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files}
    if fault == "extra leaf":
        leaves["leaf_8"] = np.zeros(1)
        match = "checkpoint has 9 leaves but template has 8"
    elif fault == "missing leaf":
        del leaves["leaf_7"]
        match = "checkpoint has 7 leaves but template has 8"
    else:
        match = "leaf shape mismatch"
    np.savez(path, **leaves)
    like = _template(tiny_dataset, hidden_dim=8 if fault == "shape" else 16)
    with pytest.raises(ValueError, match=match):
        tckpt.restore_state(path, like=like)
    with pytest.raises(ValueError, match=match):
        jckpt.restore_state(path, like=jtrain.create_state(tiny_dataset.apply_config(
            JConfig(**KW, hidden_dim=8 if fault == "shape" else 16))))


def test_two_and_two_epochs_equal_four(tiny_dataset, tmp_path):
    """At dropout 0 on the CPU: a run of 2 epochs, saved and restored into a
    fresh state and run 2 more, gives epochs 3-4 and the weights of a 4-epoch
    run."""
    ds = to_torch_dataset(tiny_dataset)
    cfg = dataclasses.replace(GCNConfig(**KW), dropout=0.0)
    full = ttrain.run(dataclasses.replace(cfg, epochs=4), ds, device="cpu", verbose=False)
    first = ttrain.run(cfg, ds, device="cpu", verbose=False)
    path = str(tmp_path / "half.npz")
    tckpt.save_state(path, first.state)
    like = ttrain.create_state(ds.apply_config(cfg), "cpu")
    second = ttrain.run(cfg, ds, device="cpu", verbose=False,
                        initial_state=tckpt.restore_state(path, like=like))
    keys = ("train_loss", "train_acc", "val_loss", "val_acc")
    assert [[h[k] for k in keys] for h in second.history] == \
        [[h[k] for k in keys] for h in full.history[2:]]
    for g, w in zip(_port_leaves(second.state)[:-2], _port_leaves(full.state)[:-2]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert int(second.state.opt.step) == 4
