"""The port's GAT (models/gat.py, ops/attention.py, the reverse-edge map of
ops/ell.py) on the CPU against the plain reference in tests/gat_reference.py.

The graph is small and skewed: one row of 300 slots, longer than an ELL
chunk (256), so that its work items are split and the reverse map spans
chunks. At the same seeded weights the port and the reference agree on the
logits, the loss and every parameter's gradient, and over 3 Adam steps of
the fused trainer, with dropout off and with the port's masks fed in (read
back as the benchmark reads them: the dropped x and the hidden layer's mask
from the tensors saved for the backward, the attention's from the seeds its
op saves, expanded by ``attention_keep``). The reverse map is an involution
on a symmetric pattern and pairs each edge with its transpose on an
asymmetric one; the config refuses unknown models; the GCN's weights and
epochs do not move with the GAT's fields.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from cuda_gcn_torch import kernels, train
from cuda_gcn_torch.config import GAT_FIELDS, GCNConfig
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data.graph import build_graph
from cuda_gcn_torch.models.gat import GAT
from cuda_gcn_torch.models.gcn import GCN, glorot
from cuda_gcn_torch.ops import attention as tatt
from cuda_gcn_torch.ops import ell as tell
from cuda_gcn_torch.ops.matmul import philox4x32
from tests import gat_reference as ref

N, F, C, HUB = 400, 24, 4, 300
# f32 in other orders of addition: rtol, and atol as a share of the tensor's
# largest value (the softmax's backward cancels to values far below it)
RTOL, ATOL_OF_MAX = 2e-5, 1e-5


def skewed_csr(n=N, hub=HUB, extra=900, seed=0, symmetric=True):
    """Node 0 joined to ``hub`` others, ``extra`` random edges, each pair once;
    both directions where ``symmetric``; the self-loop first in each row."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(hub, np.int64), rng.integers(0, n, extra)])
    dst = np.concatenate([rng.choice(np.arange(1, n), hub, replace=False),
                          rng.integers(0, n, extra)])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    key = np.unique(src * n + dst)
    src, dst = key // n, key % n
    deg = np.bincount(src, minlength=n) + 1
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int64)
    indices[indptr[:-1]] = np.arange(n)
    rest = np.ones(indptr[-1], bool)
    rest[indptr[:-1]] = False
    indices[rest] = dst  # src is sorted: each row's edges follow its self-loop
    return indptr.astype(np.int32), indices.astype(np.int32)


def skewed_dataset(seed=0, classes=C) -> tds.GCNDataset:
    rng = np.random.default_rng(seed + 1)
    indptr, indices = skewed_csr(seed=seed)
    f_mask = rng.random((N, F)) < 0.3
    f_indptr = np.zeros(N + 1, np.int64)
    np.cumsum(f_mask.sum(1), out=f_indptr[1:])
    f_indices = np.nonzero(f_mask)[1]
    label = rng.integers(0, classes, N).astype(np.int32)
    split = rng.choice([1, 2, 3, 0], N, p=[0.3, 0.3, 0.3, 0.1]).astype(np.int32)
    return tds.GCNDataset(graph=tds.CSR(indptr, indices),
                          feature_index=tds.CSR(f_indptr.astype(np.int32),
                                                f_indices.astype(np.int32)),
                          feature_value=rng.random(len(f_indices)).astype(np.float32) + 0.5,
                          label=label, split=split, num_nodes=N, input_dim=F,
                          output_dim=classes)


def gat_config(rate=0.0, att_rate=None, seed=5, heads=None, hidden=8):
    return GCNConfig(model="gat", hidden_dim=hidden, dropout=rate, learning_rate=0.005,
                     weight_decay=5e-4, seed=seed, heads=heads,
                     attention_dropout=rate if att_rate is None else att_rate,
                     graphsum_backend="ell")


@pytest.fixture(scope="module")
def prepared():
    ds = skewed_dataset()
    cfg, graph, x, truths = train.prepare(gat_config(), ds, "cpu")
    return ds, graph, x, truths


def ref_graph(ds):
    return ref.graph_of(ds.graph.indptr, ds.graph.indices)


def csr_slots(emap, ds) -> torch.Tensor:
    """The forward plan's slot of each edge of ``ds``'s CSR, in CSR order."""
    slot, row, col = (t.numpy() for t in emap.edges())
    indptr = ds.graph.indptr.astype(np.int64)
    r = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    key_port, key_csr = row * N + col, r * N + ds.graph.indices.astype(np.int64)
    a, b = np.argsort(key_port, kind="stable"), np.argsort(key_csr, kind="stable")
    assert np.array_equal(key_port[a], key_csr[b])
    perm = np.empty_like(a)
    perm[b] = a
    return torch.from_numpy(slot[perm])


class MaskReader:
    """Each training step's masks, from the tensors its forward saves: the
    dropped x [N, F] opens a step; the hidden layer's kept mask [N, width]
    (bool); each attention's seeds (two int64), layer by layer."""

    def __init__(self, width: int):
        self.width, self.steps = width, []

    def pack(self, t):
        if t.is_floating_point() and tuple(t.shape) == (N, F):
            self.steps.append({"x": t != 0, "hidden": [], "seeds": []})
        elif t.dtype == torch.bool and tuple(t.shape) == (N, self.width) and self.steps:
            self.steps[-1]["hidden"].append(t.clone())
        elif t.dtype == torch.int64 and tuple(t.shape) == (2,) and self.steps:
            self.steps[-1]["seeds"].append(t.tolist())
        return t

    def drops(self, emap, ds, heads, rate, att_rate):
        slots = csr_slots(emap, ds)
        return [ref.Dropout(x=s["x"], hidden=s["hidden"],
                            attention=[tatt.attention_keep(seeds, slots, k, att_rate)
                                       for seeds, k in zip(s["seeds"], heads)],
                            keep=1.0 - rate, att_keep=1.0 - att_rate) for s in self.steps]


def ref_inputs(ds, truths):
    x = torch.from_numpy(ds.dense_features(np.float32))
    return x, ref_graph(ds), truths[1], truths[2]


def assert_close(got, want, what):
    atol = ATOL_OF_MAX * float(want.abs().max())
    err = float((got - want).abs().max())
    assert torch.allclose(got, want, rtol=RTOL, atol=atol), f"{what}: off by {err:.3e}"


def test_reference_imports_nothing_of_the_port_or_jax():
    path = os.path.join(os.path.dirname(__file__), "gat_reference.py")
    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "cuda_gcn_torch",
                                                        "cuda_gcn_tpu")]
    ref.use_float32()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_the_long_row_is_split_across_chunks(prepared):
    _, graph, _, _ = prepared
    emap = graph.edge_map
    assert int(graph.ell.row_len.max()) > HUB > tell.ELL_CHUNK_SLOTS
    assert emap.plan_t is emap.plan and graph.symmetric
    assert emap.partial_rows.tolist() == [0, 0]
    assert graph.ell.split_rows.tolist() == [0]


@pytest.mark.parametrize("heads,fh", [(8, 8), (1, 7), (3, 5)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_attention_matches_the_reference_layer(prepared, heads, fh, rate):
    """The op's forward and its gradients in z, sl and sr against the
    reference's layer (whose scores it computes from z and a_l, a_r)."""
    ds, graph, _, _ = prepared
    emap = graph.edge_map
    gen = torch.Generator().manual_seed(heads * 10 + fh)
    z = torch.randn(N, heads * fh, generator=gen, requires_grad=True)
    a_l, a_r = (torch.randn(heads, fh, generator=gen, requires_grad=True) for _ in range(2))
    g = torch.randn(N, heads * fh, generator=gen)
    z3 = z.view(N, heads, fh)
    out = tatt.attention(z, (z3 * a_l).sum(-1), (z3 * a_r).sum(-1), emap, heads, 0.2, rate,
                         torch.Generator().manual_seed(1), True)
    got = torch.autograd.grad(out, (z, a_l, a_r), g)
    seeds = torch.empty(2, dtype=torch.int64).random_(
        generator=torch.Generator().manual_seed(1)).tolist()
    mask = tatt.attention_keep(seeds, csr_slots(emap, ds), heads, rate) if rate else None
    want_out = ref.attention_layer(z, a_l, a_r, ref_graph(ds), heads, 0.2, mask, 1.0 - rate)
    want = torch.autograd.grad(want_out, (z, a_l, a_r), g)
    assert_close(out, want_out, "out")
    for name, a, b in zip(("z", "a_l", "a_r"), got, want):
        assert_close(a, b, f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_plain_backward_is_autograd_of_the_plain_forward(prepared, rate):
    """The kernels' backward formulas (row sums A, B, C; the column pass)
    restated in ``attention_backward_plain`` give autograd's gradients of the
    plain forward, in f64."""
    _, graph, _, _ = prepared
    emap, heads = graph.edge_map, 8
    gen = torch.Generator().manual_seed(3)
    z, g = (torch.randn(N, 64, generator=gen, dtype=torch.float64) for _ in range(2))
    sl, sr = (torch.randn(N, heads, generator=gen, dtype=torch.float64) for _ in range(2))
    seeds = torch.tensor([123456789, 987654321]) if rate else None
    leaves = [t.clone().requires_grad_(True) for t in (z, sl, sr)]
    out, stats = tatt.attention_forward_plain(emap, *leaves, heads, 0.2, rate, seeds)
    want = torch.autograd.grad(out, leaves, g)
    got = tatt.attention_backward_plain(emap, g, z, sl, sr, stats.detach(), heads, 0.2, rate,
                                        seeds)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("masks", [False, True])
def test_logits_loss_and_gradients_match_the_reference(prepared, masks):
    """One training forward and backward of the port's model against the
    reference at the same seeded weights: logits, loss, each parameter's
    gradient; with ``masks`` at dropout 0.6 everywhere, the port's masks fed
    to the reference."""
    ds, graph, x, truths = prepared
    rate = 0.6 if masks else 0.0
    cfg = ds.apply_config(gat_config(rate))
    state = train.create_state(cfg, "cpu")
    params = ref.init_params(cfg.layer_dims(), cfg.layer_heads(), cfg.seed)
    assert list(params) == [n for n, _ in state.model.named_parameters()]
    for (name, p) in state.model.named_parameters():
        assert torch.equal(p.detach(), params[name]), name
    reader = MaskReader(64)
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        loss, logits, _ = state.model.loss_fn(graph, x, truths[1], weight_decay=5e-4,
                                              dropout_rate=rate, generator=state.generator,
                                              training=True)
        loss.backward()
    drop = reader.drops(graph.edge_map, ds, cfg.layer_heads(), rate, rate)[0] if masks else None
    if masks:
        assert len(reader.steps) == 1 and len(drop.hidden) == 1 and len(drop.attention) == 2
    want_loss, want_logits, want_grads = ref.gradients(params, ref_inputs(ds, truths)[0],
                                                       ref_graph(ds), truths[1],
                                                       cfg.layer_heads(), 0.2, 5e-4, drop)
    assert_close(logits.detach(), want_logits, "logits")
    assert_close(loss.detach(), want_loss, "loss")
    for name, p in state.model.named_parameters():
        assert_close(p.grad, want_grads[name], f"grad {name}")


@pytest.mark.parametrize("masks", [False, True])
def test_three_adam_steps_of_the_fused_trainer(prepared, masks):
    """Three epochs of ``train.run_epochs_chunked`` (the pass-fused pair)
    against three reference steps: each step's training loss, the validation
    loss after it, the final weights."""
    ds, graph, x, truths = prepared
    rate = 0.6 if masks else 0.0
    cfg = ds.apply_config(gat_config(rate))
    state = train.create_state(cfg, "cpu")
    params = ref.init_params(cfg.layer_dims(), cfg.layer_heads(), cfg.seed)
    reader = MaskReader(64)
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        rows = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=3,
                                        dropout_rate=rate, weight_decay=5e-4, lr=0.005)
    drops = reader.drops(graph.edge_map, ds, cfg.layer_heads(), rate, rate) if masks \
        else [None] * 3
    assert len(drops) == 3
    xr, g, t1, t2 = ref_inputs(ds, truths)
    tl, vl, final = ref.train_steps(params, xr, g, t1, t2, cfg.layer_heads(), 0.2, 5e-4, 0.005,
                                    drops)
    assert_close(rows[:, 0], torch.tensor(tl), "train loss")
    assert_close(rows[:, 2], torch.tensor(vl), "val loss")
    for name, p in state.model.named_parameters():
        torch.testing.assert_close(p.detach(), final[name], rtol=1e-4, atol=1e-6,
                                   msg=f"weights {name}")


def test_fused_loop_equals_the_stepwise_loop(prepared):
    """The pair draws the generator in the stepwise forward's order (x's mask,
    layer 0's attention seeds, the hidden mask, layer 1's), so both loops
    train the same steps."""
    ds, graph, x, truths = prepared
    cfg = ds.apply_config(gat_config(0.6))
    kw = dict(dropout_rate=0.6, weight_decay=5e-4, lr=0.005)
    a = train.create_state(cfg, "cpu")
    fused = train.run_epochs(a, graph, x, truths[1], truths[2], epochs=3, **kw)
    b = train.create_state(cfg, "cpu")
    stepwise = torch.stack([train._es_epoch(b, graph, x, truths[1], truths[2], **kw)
                            for _ in range(3)])
    torch.testing.assert_close(fused, stepwise, rtol=1e-6, atol=1e-7)


def _edges_of(plan):
    slot, row, col = (t.numpy() for t in tell.slot_edges(plan))
    return slot, row, col


def test_reverse_map_is_an_involution_on_a_symmetric_pattern(prepared):
    _, graph, _, _ = prepared
    rev = graph.edge_map.rev.long()
    slot, row, col = _edges_of(graph.ell)
    assert (rev >= 0).sum() == len(slot) and bool((rev[torch.from_numpy(slot)] >= 0).all())
    real = torch.from_numpy(slot)
    assert torch.equal(rev[rev[real]], real)
    by_slot = {int(s): (int(r), int(c)) for s, r, c in zip(slot, row, col)}
    for s in slot[:: max(1, len(slot) // 500)]:
        r, c = by_slot[int(s)]
        assert by_slot[int(rev[int(s)])] == (c, r)


def test_reverse_map_on_an_asymmetric_pattern():
    indptr, indices = skewed_csr(symmetric=False, seed=3)
    graph = build_graph(tds.CSR(indptr, indices), backend="ell", device="cpu")
    assert not graph.symmetric and graph.ell_t is not None
    emap = tell.edge_map(graph.ell, graph.ell_t)
    f_slot, f_row, f_col = _edges_of(graph.ell)
    t_slot, t_row, t_col = _edges_of(graph.ell_t)
    fwd = {int(s): (int(r), int(c)) for s, r, c in zip(f_slot, f_row, f_col)}
    rev = emap.rev.numpy()
    assert sorted(rev[t_slot].tolist()) == sorted(f_slot.tolist())  # each edge once
    for s, r, c in zip(t_slot, t_row, t_col):
        assert fwd[int(rev[s])] == (int(c), int(r))
    assert emap.partial_rows_t.tolist() == [0] * int(graph.ell_t.n_partials)
    with pytest.raises(ValueError, match="transpose"):
        tell.reverse_slots(graph.ell, graph.ell)


def test_attention_backward_on_an_asymmetric_pattern():
    """The op over Âᵀ's plan and the reverse map: its gradients are autograd's
    of the reference layer on the asymmetric pattern."""
    indptr, indices = skewed_csr(symmetric=False, seed=3)
    graph = build_graph(tds.CSR(indptr, indices), backend="ell", device="cpu")
    emap = tell.edge_map(graph.ell, graph.ell_t)
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(N, 16, generator=gen, requires_grad=True)
    sl, sr = (torch.randn(N, 2, generator=gen, requires_grad=True) for _ in range(2))
    out = tatt.attention(z, sl, sr, emap, 2, 0.2, 0.0, None, True)
    g = torch.randn(N, 16, generator=gen)
    got = torch.autograd.grad(out, (z, sl, sr), g)
    node = ref.graph_of(indptr, indices)
    e = torch.nn.functional.leaky_relu(sl[node.dst] + sr[node.src], 0.2)
    m = torch.full((N, 2), -torch.inf).scatter_reduce(0, node.dst[:, None].expand(-1, 2),
                                                     e.detach(), "amax")
    p = torch.exp(e - m[node.dst])
    den = torch.zeros(N, 2).index_add(0, node.dst, p)
    z3 = z.view(N, 2, 8)
    want_out = torch.zeros_like(z3).index_add(0, node.dst,
                                              (p / den[node.dst])[..., None] * z3[node.src])
    want = torch.autograd.grad(want_out.view(N, 16), (z, sl, sr), g)
    for a, b in zip(got, want):
        assert_close(a, b, "gradient")


def test_attention_mask_layout_and_share():
    """Head k of slot s is word k % 4 of the Philox call at counter
    s·⌈K/4⌉ + k/4 under the seeds, kept below q·2^32; the share is 1 - p."""
    seeds = [0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321]
    slots = torch.arange(5000, dtype=torch.int64)
    keep = tatt.attention_keep(seeds, slots, 8, 0.6)
    thresh = kernels.gat_keep(0.6)[2]
    for s, k in [(0, 0), (5, 6), (4999, 3), (77, 7)]:
        c = s * 2 + k // 4
        ctr = torch.tensor([[c & 0xFFFFFFFF, c >> 32, seeds[1] & 0xFFFFFFFF, seeds[1] >> 32]])
        u = philox4x32((seeds[0] & 0xFFFFFFFF, seeds[0] >> 32), ctr)[0, k % 4]
        assert bool(keep[s, k]) == (int(u) < thresh)
    share = keep.float().mean().item()
    assert abs(share - 0.4) < 4 * (0.24 / keep.numel()) ** 0.5
    one = tatt.attention_keep(seeds, slots, 1, 0.6)
    assert torch.equal(one[:, 0], tatt.attention_keep(seeds, slots * 1, 4, 0.6)[:, 0])


@pytest.mark.parametrize("bad", [dict(model="gatv2"), dict(model="GCN"),
                                 dict(model="gat", compute_dtype="bfloat16"),
                                 dict(model="gat", heads=(8, 8, 1)),
                                 dict(model="gat", heads=(0, 1))])
def test_config_refuses_unknown_models_and_what_a_gat_cannot_run(bad):
    with pytest.raises(ValueError, match="model|heads|float32"):
        GCNConfig(**bad)


def test_gcn_is_unchanged_by_the_gat_fields():
    """The GCN's weights are the Glorot draws of before, and its epochs and
    graph do not move with the GAT's fields, which a GCN never reads."""
    ds = skewed_dataset(2)
    base = ds.apply_config(GCNConfig(seed=3, graphsum_backend="ell", dropout=0.5))
    other = dataclasses.replace(base, heads=(2, 1), attention_dropout=0.1, leaky_slope=0.5)
    gen = torch.Generator().manual_seed(3)
    w1, w2 = glorot(F, 16, gen), glorot(16, C, gen)
    runs = []
    for cfg in (base, other):
        _, graph, x, truths = train.prepare(cfg, ds, "cpu")
        assert graph.edge_map is None
        state = train.create_state(cfg, "cpu")
        assert isinstance(state.model, GCN)
        assert torch.equal(state.model.w1.detach(), w1) and torch.equal(state.model.w2.detach(), w2)
        rows = train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=3,
                                        dropout_rate=0.5, weight_decay=5e-4, lr=0.01)
        runs.append((rows, [p.detach().clone() for p in state.model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert set(GAT_FIELDS) <= {f.name for f in dataclasses.fields(GCNConfig)}


def test_gat_refuses_a_backend_without_the_ell_plan():
    with pytest.raises(ValueError, match="ell"):
        train.prepare(GCNConfig(model="gat", graphsum_backend="bsr"), skewed_dataset(), "cpu")


@pytest.mark.parametrize("heads,fh,bases,want", [
    (8, 8, (0, 0), (4, 1, 8, 2)), (1, 41, (0,), (1, 8, 8, 8)), (3, 5, (), (1, 1, 4, 8)),
    (1, 7, (), (1, 1, 1, 8)), (8, 8, (0, 8), (2, 1, 8, 4)), (1, 64, (), (4, 8, 8, 2)),
    (4, 16, (4,), (1, 2, 8, 8)), (33, 1, (), None)])
def test_attention_lane_layout(heads, fh, bases, want):
    """(VEC, L2, G, STEPS): the widest aligned load, the fewest lanes a head
    at which a lane holds at most 8 floats, so the most slots side by side."""
    if want is None:
        with pytest.raises(ValueError, match="32 lanes"):
            kernels.gat_layout(heads, fh, *bases)
    else:
        vec, l2, g, steps = kernels.gat_layout(heads, fh, *bases)
        assert (vec, l2, g, steps) == want
        assert steps * l2 * vec >= fh and heads * l2 <= g <= 32 and vec * steps <= 8


# ---- heads at 16-byte-padded rows (ops/attention.py ``head_stride``) ------

@pytest.mark.parametrize("heads,fh,ld,want,wide", [
    (1, 41, 44, (4, 8, 8, 2), (4, 4, 4, 4)), (8, 8, 8, (4, 1, 8, 2), (4, 1, 8, 2)),
    (4, 7, 8, (4, 1, 4, 2), (4, 1, 4, 2)), (3, 5, 8, (4, 1, 4, 2), (4, 1, 4, 2)),
    (1, 7, 8, (4, 1, 1, 2), (4, 1, 1, 2)), (2, 6, 8, (4, 1, 2, 2), (4, 1, 2, 2))])
def test_padded_head_stride_and_its_layout(heads, fh, ld, want, wide):
    """A head of F' features takes LD = 4·⌈F'/4⌉ floats; the lane split over
    LD loads float4 (at 1 x 41 the forward's 2 a lane where the 41 floats took
    8 scalar loads, the backward passes' 4 a lane), and 8 x 8 keeps its split;
    the GAT's weight is padded per head to LD columns, the parameter left
    [F_in, K·F']."""
    assert tatt.head_stride(fh) == ld
    assert kernels.gat_layout(heads, ld, 0, 0, 0) == want
    assert kernels.gat_layout(heads, ld, 0, 0, 0, wide=True) == wide
    assert kernels.gat_layout(heads, fh, 0, 0) == kernels.gat_layout(heads, fh, 0, 0, wide=True)
    model = GAT((6, fh), (heads,), torch.Generator().manual_seed(0))
    (w,) = model.weights()
    assert tuple(model.w1.shape) == (6, heads * fh) and tuple(w.shape) == (6, heads * ld)
    w3 = w.detach().view(6, heads, ld)
    assert torch.equal(w3[..., :fh], model.w1.detach().view(6, heads, fh))
    assert not w3[..., fh:].any()
    assert (w is model.w1) == (ld == fh)


def _padded_inputs(heads, fh, junk):
    """z, g [N, K·F'] and the scores, and z, g at the padded stride with
    ``junk`` in each head's padding."""
    ld = tatt.head_stride(fh)
    gen = torch.Generator().manual_seed(heads * 10 + fh)
    z, g = (torch.randn(N, heads * fh, generator=gen) for _ in range(2))
    sl, sr = (torch.randn(N, heads, generator=gen) for _ in range(2))
    zp, gp = (torch.full((N, heads, ld), junk).index_copy_(2, torch.arange(fh),
                                                            t.view(N, heads, fh)).view(N, -1)
              for t in (z, g))
    return z, g, sl, sr, zp, gp


def _split(t, heads, fh):
    t3 = t.view(N, heads, -1)
    return t3[..., :fh], t3[..., fh:]


@pytest.mark.parametrize("junk", [0.0, 1e3])
@pytest.mark.parametrize("heads,fh", [(1, 41), (4, 7), (3, 5), (1, 7)])
@pytest.mark.parametrize("rate", [0.0, 0.6])
def test_plain_versions_at_the_padded_stride(prepared, heads, fh, rate, junk):
    """At the padded stride the plain forward and both backward passes give
    the unpadded ones' values bit for bit, whatever the padding of z and g
    holds, and write 0 in the padding of out and dz."""
    _, graph, _, _ = prepared
    emap = graph.edge_map
    z, g, sl, sr, zp, gp = _padded_inputs(heads, fh, junk)
    seeds = torch.tensor([123456789, 987654321]) if rate else None
    out, stats = tatt.attention_forward_plain(emap, z, sl, sr, heads, 0.2, rate, seeds)
    outp, statsp = tatt.attention_forward_plain(emap, zp, sl, sr, heads, 0.2, rate, seeds, fh=fh)
    dz, dsl, dsr = tatt.attention_backward_plain(emap, g, z, sl, sr, stats, heads, 0.2, rate,
                                                 seeds)
    dzp, dslp, dsrp = tatt.attention_backward_plain(emap, gp, zp, sl, sr, statsp, heads, 0.2,
                                                    rate, seeds, fh=fh)
    for name, got, want in (("out", outp, out), ("dz", dzp, dz)):
        feats, pad = _split(got, heads, fh)
        assert torch.equal(feats, want.view(N, heads, fh)), name
        assert pad.numel() == N * heads * (tatt.head_stride(fh) - fh) and not pad.any(), name
    for a, b in ((statsp, stats), (dslp, dsl), (dsrp, dsr)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("heads,fh", [(1, 41), (4, 7)])
def test_the_op_at_the_padded_stride(prepared, heads, fh):
    """Through autograd: out and z's gradient of the op at the padded stride
    are the unpadded op's, with zero padding, and sl, sr get the same
    gradients."""
    _, graph, _, _ = prepared
    emap = graph.edge_map
    z, g, sl, sr, zp, gp = _padded_inputs(heads, fh, 0.0)
    got, want = [], []
    for zz, gg, kw, into in ((z, g, {}, want), (zp, gp, dict(fh=fh), got)):
        leaves = [t.clone().requires_grad_(True) for t in (zz, sl, sr)]
        out = tatt.attention(*leaves, emap, heads, 0.2, 0.6,
                             torch.Generator().manual_seed(1), True, **kw)
        into += [out.detach(), *torch.autograd.grad(out, leaves, gg)]
    for name, a, b in zip(("out", "dz"), (got[0], got[1]), (want[0], want[1])):
        feats, pad = _split(a, heads, fh)
        assert torch.equal(feats, b.view(N, heads, fh)) and not pad.any(), name
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])


@pytest.mark.parametrize("heads,hidden,classes", [((3, 1), 3, 7), ((2, 2), 6, 5)])
@pytest.mark.parametrize("masks", [False, True])
def test_odd_widths_match_the_reference(heads, hidden, classes, masks):
    """A GAT whose hidden and output heads are no multiple of 4 wide (z at
    the padded stride in both layers) against the reference at the same
    seeded weights: logits, loss and every parameter's gradient; with
    ``masks`` at dropout 0.6, the port's masks fed to the reference."""
    ds = skewed_dataset(4, classes=classes)
    rate = 0.6 if masks else 0.0
    cfg = ds.apply_config(gat_config(rate, heads=heads, hidden=hidden))
    cfg, graph, x, truths = train.prepare(cfg, ds, "cpu")
    state = train.create_state(cfg, "cpu")
    params = ref.init_params(cfg.layer_dims(), cfg.layer_heads(), cfg.seed)
    reader = MaskReader(heads[0] * hidden)
    with torch.autograd.graph.saved_tensors_hooks(reader.pack, lambda t: t):
        loss, logits, _ = state.model.loss_fn(graph, x, truths[1], weight_decay=5e-4,
                                              dropout_rate=rate, generator=state.generator,
                                              training=True)
        loss.backward()
    drop = reader.drops(graph.edge_map, ds, heads, rate, rate)[0] if masks else None
    if masks:
        assert len(reader.steps) == 1 and len(drop.hidden) == 1 and len(drop.attention) == 2
    want_loss, want_logits, want_grads = ref.gradients(params, ref_inputs(ds, truths)[0],
                                                       ref_graph(ds), truths[1], heads, 0.2,
                                                       5e-4, drop)
    assert tuple(logits.shape) == (N, classes)
    assert_close(logits.detach(), want_logits, "logits")
    assert_close(loss.detach(), want_loss, "loss")
    for name, p in state.model.named_parameters():
        assert tuple(p.grad.shape) == tuple(params[name].shape), name
        assert_close(p.grad, want_grads[name], f"grad {name}")


@pytest.mark.parametrize("fused", [False, True])
def test_a_step_saves_what_the_benchmark_reads(fused):
    """At the benchmark's widths (8 heads of 8, one output head of 41: w2
    padded to 44 columns in the product) the parameters keep their names,
    order and shapes, and a training step saves for its backward one float
    tensor of x's shape (the dropped x), the hidden layer's kept mask (bool
    [N, 64]) and two int64 seeds a layer, and no other tensor of x's shape:
    what the benchmark's mask reader keys on."""
    ds = skewed_dataset(1, classes=41)
    cfg, graph, x, truths = train.prepare(ds.apply_config(gat_config(0.6)), ds, "cpu")
    state = train.create_state(cfg, "cpu")
    assert [(n, tuple(p.shape)) for n, p in state.model.named_parameters()] == [
        ("w1", (F, 64)), ("att_l1", (8, 8)), ("att_r1", (8, 8)), ("w2", (64, 41)),
        ("att_l2", (1, 41)), ("att_r2", (1, 41))]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        if fused:
            train.run_epochs_chunked(state, graph, x, truths[1], truths[2], epochs=1,
                                     dropout_rate=0.6, weight_decay=5e-4, lr=0.005)
        else:
            state.model.loss_fn(graph, x, truths[1], weight_decay=5e-4, dropout_rate=0.6,
                                generator=state.generator, training=True)[0].backward()
    x_like = [t for t in saved if tuple(t.shape) == (N, F)]
    assert len(x_like) == 1 and x_like[0].is_floating_point()
    assert [tuple(t.shape) for t in saved if t.dtype == torch.bool and t.dim() == 2] == [(N, 64)]
    assert len([t for t in saved if t.dtype == torch.int64 and tuple(t.shape) == (2,)]) == 2
