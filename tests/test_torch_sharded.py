"""The port's sharded trainer on gloo ranks against the JAX package's on its
virtual CPU mesh (cuda_gcn_tpu.parallel.sharded on make_mesh(2) and (4)).

For each world size one module-scoped spawn (``multihost.run_ranks``, the
``spawn`` start method, a ``file://`` store) runs every case of
tests/torch_sharded_cases.py on ``tiny_dataset`` partitioned by the port,
with the JAX package's weights where the case compares with it. Tolerances:
f32 halo, the JAX package's own for sharded against single-device
(tests/test_parallel.py): eval loss rtol 1e-5, accuracy rtol 1e-6,
gradients rtol 1e-4 / atol 1e-6; fused epochs and whole runs rtol 1e-4 /
atol 1e-5 (tests/test_model.py:126-157, the epoch tolerance of the port's
other parity tests); bf16 halo (against JAX's bf16 halo, and against the
port's f32 halo) loss rtol 5e-3, gradients rtol 0.05 / atol 5e-4
(tests/test_parallel.py:582-586). Dropout is 0 wherever the packages are
compared: each draws its own random bits.
"""

import dataclasses
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from cuda_gcn_tpu import train as jtrain
from cuda_gcn_tpu.config import GCNConfig as JConfig
from cuda_gcn_tpu.models import gcn as jgcn
from cuda_gcn_tpu.parallel import sharded as jsharded
from cuda_gcn_tpu.utils import checkpoint as jckpt

import torch_sharded_cases
from cuda_gcn_torch import cli as tcli
from cuda_gcn_torch.config import GCNConfig
from cuda_gcn_torch.parallel import multihost, sharded
from test_torch_train import to_torch_dataset

HALOS = ("float32", "bfloat16")
SPAWN_TIMEOUT = 300
EPOCH_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_TOL = dict(rtol=0.05, atol=5e-4)
FUSED_EPOCHS = 4


def _jax_grads(mesh, params, inputs, truth, cfg):
    def loss(p):
        return jsharded.sharded_loss_fn(mesh, p, inputs, truth, jax.random.PRNGKey(0),
                                        dropout_rate=0.0, weight_decay=cfg.weight_decay,
                                        training=False, halo_dtype=cfg.halo_dtype)

    (l, a), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return float(l), float(a), {k: np.asarray(v) for k, v in g.items()}


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request, tiny_dataset, tmp_path_factory):
    """{'P', 'jax': {case: result}, 'port': {case: rank 0's result},
    'ranks': [every rank's results]} for one world size."""
    p = request.param
    ds, tds = tiny_dataset, to_torch_dataset(tiny_dataset)
    mesh = jsharded.make_mesh(p)
    base = ds.apply_config(JConfig(hidden_dim=8, halo_dtype="float32", dropout=0.0))
    _, jin, jtruths = jsharded.prepare_sharded(base, ds, mesh)
    cfg, shards, _ = sharded.prepare_sharded(
        GCNConfig(hidden_dim=8, dropout=0.0, halo_dtype="float32"), tds, p)
    cfg_sparse, shards_sparse, _ = sharded.prepare_sharded(
        dataclasses.replace(cfg, feature_matmul="sparse"), tds, p)
    params = jgcn.init_params(jax.random.PRNGKey(3), base.layer_dims())
    jax_out, cases = {}, {}
    rng = np.random.default_rng(0)
    z = rng.standard_normal((p * shards[0].part.block, 8)).astype(np.float32)
    ct = rng.standard_normal(z.shape).astype(np.float32)
    for halo in HALOS:
        jc = dataclasses.replace(base, halo_dtype=halo)
        tc = dataclasses.replace(cfg, halo_dtype=halo)
        ev = jsharded.make_sharded_eval_step(mesh, jc)
        jax_out[f"eval-{halo}"] = tuple(map(float, ev(params, jin, jtruths[3])))
        cases[f"eval-{halo}"] = dict(kind="eval", cfg=tc, shards=shards, params=_np(params),
                                     split=3)
        jax_out[f"grads-{halo}"] = _jax_grads(mesh, params, jin, jtruths[1], jc)
        cases[f"grads-{halo}"] = dict(kind="grads", cfg=tc, shards=shards,
                                      params=_np(params), split=1)
        jf = dataclasses.replace(jc, hidden_dim=16, epochs=FUSED_EPOCHS)
        state = jtrain.create_state(jf)
        run = jsharded.make_sharded_run_epochs(mesh, jf)
        state_f, m = run(jax.tree_util.tree_map(jnp.copy, state), jin, jtruths[1],
                         jtruths[2], epochs=FUSED_EPOCHS)
        jax_out[f"fused-{halo}"] = (np.stack([np.asarray(v) for v in m], 1), _np(state_f.params))
        cases[f"fused-{halo}"] = dict(kind="fused", epochs=FUSED_EPOCHS, shards=shards,
                                      cfg=dataclasses.replace(tc, hidden_dim=16),
                                      params=_np(state.params))
        cases[f"pair-{halo}"] = dict(kind="pair", cfg=tc, shards=shards, z=z, ct=ct)
        if halo == "bfloat16":
            cases["chunked"] = dict(kind="chunked", epochs=5, chunk=2, shards=shards,
                                    cfg=dataclasses.replace(tc, hidden_dim=16, dropout=0.5),
                                    params=_np(state.params))
        if halo == "float32":
            cases["sparse-eval"] = dict(cases["eval-float32"], cfg=cfg_sparse,
                                        shards=shards_sparse)
            cases["sparse-grads"] = dict(cases["grads-float32"], cfg=cfg_sparse,
                                         shards=shards_sparse)
            cases["sparse-fused"] = dict(cases["fused-float32"], shards=shards_sparse,
                                         cfg=dataclasses.replace(cfg_sparse, hidden_dim=16))
            # a run from the JAX state after the fused epochs, through a checkpoint
            path = str(tmp_path_factory.mktemp(f"ckpt{p}") / "fused.npz")
            jckpt.save_state(path, state_f)
            jr = dataclasses.replace(jf, epochs=3)
            restored = jckpt.restore_state(path, like=jtrain.create_state(jr))
            res = jsharded.run_sharded(jr, ds, mesh, verbose=False, initial_state=restored)
            jax_out["resumed"] = res
            cases["resumed"] = dict(kind="run", shards=shards, checkpoint=path,
                                    cfg=dataclasses.replace(tc, hidden_dim=16, epochs=3))
    three = ds.apply_config(JConfig(hidden_dims=(16, 8), halo_dtype="float32"))
    p3 = jgcn.init_params(jax.random.PRNGKey(5), three.layer_dims())
    jax_out["three"] = tuple(map(float, jsharded.make_sharded_eval_step(mesh, three)(
        p3, jin, jtruths[3])))
    cases["three"] = dict(kind="eval", split=3, shards=shards, params=_np(p3),
                          cfg=dataclasses.replace(cfg, hidden_dims=(16, 8),
                                                  halo_dtype="float32"))
    # early stopping from the JAX package's initial weights, through a checkpoint
    es = dict(hidden_dim=8, epochs=60, early_stopping=4, seed=0, learning_rate=0.6,
              dropout=0.0, halo_dtype="float32")
    path = str(tmp_path_factory.mktemp(f"es{p}") / "init.npz")
    jes = ds.apply_config(JConfig(**es))
    jckpt.save_state(path, jtrain.create_state(jes))
    jax_out["es"] = jsharded.run_sharded(jes, ds, mesh, verbose=False,
                                         initial_state=jtrain.create_state(jes))
    cases["es"] = dict(kind="run", shards=shards, checkpoint=path,
                       cfg=dataclasses.replace(cfg, **es))
    ranks = multihost.run_ranks(torch_sharded_cases.run_cases, p, (cases,),
                                timeout=SPAWN_TIMEOUT)
    return dict(P=p, jax=jax_out, port=ranks[0], ranks=ranks)


@pytest.mark.parametrize("halo", HALOS)
def test_sharded_eval_matches_jax(world, halo):
    got, want = world["port"][f"eval-{halo}"], world["jax"][f"eval-{halo}"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5 if halo == "float32"
                               else BF16_LOSS_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


@pytest.mark.parametrize("halo", HALOS)
def test_sharded_train_step_grads_match_jax(world, halo):
    loss, acc, grads = world["port"][f"grads-{halo}"]
    j_loss, j_acc, j_grads = world["jax"][f"grads-{halo}"]
    f32 = halo == "float32"
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5 if f32 else BF16_LOSS_RTOL)
    np.testing.assert_allclose(acc, j_acc, rtol=1e-6)
    for k in j_grads:
        np.testing.assert_allclose(grads[k], j_grads[k],
                                   **(dict(rtol=1e-4, atol=1e-6) if f32 else BF16_GRAD_TOL))
    # every rank holds the same summed gradient
    for r in world["ranks"][1:]:
        for k in grads:
            np.testing.assert_array_equal(r[f"grads-{halo}"][2][k], grads[k])


@pytest.mark.parametrize("halo", HALOS)
def test_sharded_fused_epochs_match_jax(world, halo):
    """Four fused epochs at dropout 0: metrics and the final weights."""
    m, params = world["port"][f"fused-{halo}"]
    jm, jparams = world["jax"][f"fused-{halo}"]
    assert m.shape == (FUSED_EPOCHS, 4)
    if halo == "float32":
        np.testing.assert_allclose(m, jm, **EPOCH_TOL)
        for k in jparams:
            np.testing.assert_allclose(params[k], jparams[k], **EPOCH_TOL)
    else:
        np.testing.assert_allclose(m[:, 0::2], jm[:, 0::2], rtol=BF16_LOSS_RTOL)
        np.testing.assert_allclose(m[:, 1::2], jm[:, 1::2], atol=2 / 40)  # 2 of 40 nodes


def test_sharded_chunked_equals_the_fused_loop(world):
    """``run_epochs_chunked`` (chunks of 2, eager under gloo) against
    ``run_epochs`` over 5 epochs at dropout 0.5, bf16 halo, on every rank:
    metrics, weights, moments, step and generator bit for bit."""
    for r in world["ranks"]:
        eager, chunked = r["chunked"]
        assert eager[0].shape == (5, 4) and eager[3] == chunked[3] == 5
        np.testing.assert_array_equal(chunked[0], eager[0])
        for got, want in zip(chunked[1:3], eager[1:3]):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(chunked[4], eager[4])


def test_bf16_halo_against_f32(world):
    """The bf16 wire type against the f32 one, both in the port."""
    l16, _, g16 = world["port"]["grads-bfloat16"]
    l32, _, g32 = world["port"]["grads-float32"]
    np.testing.assert_allclose(l16, l32, rtol=BF16_LOSS_RTOL)
    for k in g32:
        np.testing.assert_allclose(g16[k], g32[k], **BF16_GRAD_TOL)
    assert world["port"]["eval-bfloat16"][0] != world["port"]["eval-float32"][0]


@pytest.mark.parametrize("halo", HALOS)
def test_pair_backward_matches_autograd_of_the_exchange(world, halo):
    """halo_graphsum_pair's hand-written train-width backward (and the
    unpaired halo_graphsum's, the same code at one width) against autograd
    through the exchange, the gather, the casts and rect_graphsum, on every
    rank; as tests/test_parallel.py:588-644 holds the JAX pair."""
    for r in world["ranks"]:
        y_pair, g_pair, y_ref, g_ref, y_one, g_one = r[f"pair-{halo}"]
        for got in (y_pair, y_one):
            np.testing.assert_allclose(got, y_ref, rtol=1e-6, atol=1e-6)
        for got in (g_pair, g_one):
            np.testing.assert_allclose(got, g_ref, rtol=1e-6, atol=1e-6)
        assert np.abs(g_ref).max() > 0


def test_three_layer_matches_jax(world):
    got, want = world["port"]["three"], world["jax"]["three"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def _history(rows):
    return np.array([[h[k] for k in ("train_loss", "train_acc", "val_loss", "val_acc")]
                     for h in rows])


def test_early_stopping_matches_jax(world):
    """run_sharded with early stopping stops at JAX's epoch with its metrics."""
    history, test_loss, test_acc, epochs_run = world["port"]["es"]
    want = world["jax"]["es"]
    assert epochs_run == want.epochs_run < 60
    np.testing.assert_allclose(_history(history), _history(want.history), **EPOCH_TOL)
    np.testing.assert_allclose(test_loss, want.test_loss, **EPOCH_TOL)


def test_initial_state_matches_jax(world):
    """run_sharded from a JAX checkpoint (weights, moments, step after the
    fused epochs) continues as JAX's run_sharded does from the same state."""
    history, test_loss, _, epochs_run = world["port"]["resumed"]
    want = world["jax"]["resumed"]
    assert epochs_run == want.epochs_run == 3
    np.testing.assert_allclose(_history(history), _history(want.history), **EPOCH_TOL)
    np.testing.assert_allclose(test_loss, want.test_loss, **EPOCH_TOL)


def test_sparse_features_per_part_equal_dense(world):
    """Each rank's CSR feature rows (make_sparse_features_parts) give the
    dense slab's eval, gradients and fused epochs."""
    port, jx = world["port"], world["jax"]
    np.testing.assert_allclose(port["sparse-eval"], jx["eval-float32"], rtol=1e-5)
    _, _, g = port["sparse-grads"]
    for k, want in jx["grads-float32"][2].items():
        np.testing.assert_allclose(g[k], want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(port["sparse-fused"][0], jx["fused-float32"][0], **EPOCH_TOL)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f][1:]


def test_cli_mesh_on_gloo_ranks(tmp_path):
    """``--mesh 2 --device cpu``: two gloo ranks train synth-cora; rank 0
    writes the history, which matches the single-device run at dropout 0."""
    flags = ["--device", "cpu", "--epochs", "2", "--dropout", "0", "--halo-dtype", "float32"]
    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("mesh", "single")}
    assert tcli.main(["synth-cora", "--mesh", "2", *flags,
                      "--metrics-jsonl", paths["mesh"]]) == 0
    assert tcli.main(["synth-cora", *flags, "--metrics-jsonl", paths["single"]]) == 0
    mesh, single = _rows(paths["mesh"]), _rows(paths["single"])
    assert [r["epoch"] for r in mesh] == [1, 2]
    for a, b in zip(mesh, single):
        for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
            np.testing.assert_allclose(a[k], b[k], **EPOCH_TOL)


def test_mesh_beyond_the_device_count_raises(monkeypatch, capsys, tmp_path):
    """With fewer cards than ranks: the CLI exits with the JAX CLI's message
    before it starts a rank, and an NCCL rank past the cards raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(multihost, "run_ranks", lambda *a, **k: pytest.fail("spawned"))
    assert tcli.main(["synth-cora", "--mesh", "2"]) == 1
    assert "--mesh 2 needs 2 devices, have 1" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="NCCL rank 1 needs cuda:1, have 1"):
        multihost.initialize(f"file://{tmp_path}/store", 2, 1)


def test_initialize_from_the_torchrun_environment(monkeypatch):
    """Without an ``init_method`` the group comes from torchrun's RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT; with neither there is one
    process, nothing to initialise, and it is the primary one."""
    for key in multihost._TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize(device="cpu") is False and multihost.is_primary()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in zip(multihost._TORCHRUN_ENV, ("0", "1", "localhost", str(port))):
        monkeypatch.setenv(key, value)
    try:
        assert multihost.initialize(device="cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert multihost.is_primary()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_a_failing_rank_ends_the_run():
    """run_ranks raises with the failing rank's traceback and ends its peer,
    which would otherwise wait in the all-reduce until the timeout."""
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank 1 gives up"):
        multihost.run_ranks(torch_sharded_cases.fail_on_rank_1, 2, timeout=SPAWN_TIMEOUT)
