"""Layer 0 on dense features: ``ops/matmul.layer0_dense_pair`` and the dense
layer-0 kernel's plain version, on the CPU.

A CPU tensor takes the model's former path, ``dropout`` then ``dense_matmul``,
bit for bit under one generator; a tensor on the card (meta tensors here, the
launcher replaced by a recorder) takes one launch of the kernel in training
and the plain product without dropout. The kernel's arithmetic is held in
``layer0_pair_plain``: the mask is Philox4x32-10 (the known-answer vectors of
its authors) at a counter of (row, column / 4), every kept value exactly
x / (1 - p), the keep share at 1 - p. The autograd Function around the kernel
is driven with the plain version in its place: it saves xd alone, nothing of
[N, H], and W's gradient is xdᵀ·g. So is chip_smoke's card check of xd,
which fails on one wrong value in the last row.
"""

import numpy as np
import pytest
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.data import dataset as tds
from cuda_gcn_torch.data.graph import build_graph
from cuda_gcn_torch.models import gcn
from cuda_gcn_torch.ops import matmul as tmm
from cuda_gcn_torch.ops.dropout import dropout
from cuda_gcn_torch.parallel import sharded

DTYPES = [torch.float32, torch.bfloat16]
SEEDS = torch.tensor([0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321], dtype=torch.int64)


def _inputs(n, f, h, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(n, f, generator=gen)
    x = torch.where(torch.rand(n, f, generator=gen) < 0.3, x, torch.zeros(()))  # sparse rows
    w = torch.randn(f, h, generator=gen) * (2.0 / (f + h)) ** 0.5
    return x.to(dtype), w


@pytest.mark.parametrize("with_eval", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,f,h,rate", [(37, 602, 16, 0.5), (20, 3703, 16, 0.5),
                                        (33, 67, 6, 0.3), (9, 500, 41, 0.1)])
def test_cpu_path_is_dropout_then_dense_matmul(n, f, h, rate, dtype, with_eval):
    """On the CPU the op is the model's former layer 0, bit for bit: the same
    generator draws the same mask, and the eval half is x @ W without a
    gradient."""
    x, w = _inputs(n, f, h, dtype)
    w.requires_grad_(True)
    got = tmm.layer0_dense_pair(x, w, rate, torch.Generator().manual_seed(5), True,
                                with_eval=with_eval)
    gen = torch.Generator().manual_seed(5)
    want_t = tmm.dense_matmul(dropout(x, rate, gen, True), w)
    if with_eval:
        assert torch.equal(got[0], want_t) and torch.equal(got[1], tmm.dense_matmul(x, w))
        assert got[0].requires_grad and not got[1].requires_grad
    else:
        assert torch.equal(got, want_t) and got.dtype == dtype
    # the model's two entries: the pair, and the train forward alone
    pair = gcn.layer0_pair(x, w, rate, torch.Generator().manual_seed(5))
    alone = gcn._layer0_transform(x, w, rate, torch.Generator().manual_seed(5), True)
    assert torch.equal(pair[0], want_t) and torch.equal(alone, want_t)


@pytest.mark.parametrize("training,rate", [(False, 0.5), (True, 0.0), (False, 0.0)])
def test_without_dropout_it_is_the_plain_product(monkeypatch, training, rate):
    """Eval or rate 0: the product of x itself, on the CPU and on the card
    alike, where nothing reaches the kernel."""
    x, w = _inputs(20, 70, 16, torch.float32)
    assert torch.equal(tmm.layer0_dense_pair(x, w, rate, None, training), x @ w)
    pair = tmm.layer0_dense_pair(x, w, rate, None, training, with_eval=True)
    assert torch.equal(pair[0], x @ w) and torch.equal(pair[1], x @ w)
    monkeypatch.setattr(kernels, "layer0_pair", lambda *a, **k: pytest.fail("launched"))
    meta = tmm.layer0_dense_pair(x.to("meta"), w.to("meta"), rate, None, training)
    assert meta.shape == (20, 16)


def _recorder(monkeypatch):
    calls = []

    def launch(x, w, seeds, rate, with_eval):
        calls.append((tuple(x.shape), tuple(w.shape), w.dtype, tuple(seeds.shape), rate,
                       with_eval))
        z = torch.empty(x.shape[0], w.shape[1], dtype=x.dtype, device=x.device)
        return torch.empty_like(x), z, torch.empty_like(z) if with_eval else None

    monkeypatch.setattr(kernels, "layer0_pair", launch)
    return calls


@pytest.mark.parametrize("h", [16, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_card_tensors_in_training_take_one_launch(monkeypatch, dtype, h):
    """On the card: the fused epoch's pair is one launch with the eval half,
    the training forward alone one without; W reaches the kernel as f32 (a
    bf16 W exactly widened), the seeds as two int64. The GAT's 64 columns
    are one call as the GCN's 16 are."""
    calls = _recorder(monkeypatch)
    x = torch.empty(60, 12, dtype=dtype, device="meta")
    for w_dtype in DTYPES:
        w = torch.empty(12, h, dtype=w_dtype, device="meta", requires_grad=True)
        zt, ze = gcn.layer0_pair(x, w, 0.5, None)
        z = gcn._layer0_transform(x, w, 0.5, None, True)
        assert zt.requires_grad and not ze.requires_grad and z.requires_grad
        assert zt.dtype == ze.dtype == z.dtype == dtype and zt.shape == (60, h)
    assert calls == [((60, 12), (12, h), torch.float32, (2,), 0.5, True),
                     ((60, 12), (12, h), torch.float32, (2,), 0.5, False)] * 2
    # the sharded trainer's fused forward is the models' own loop, which
    # builds its first layer the same way
    assert sharded.GCN.apply_pair is gcn.GraphModel.apply_pair


def test_x_is_data(monkeypatch):
    _recorder(monkeypatch)
    x = torch.empty(60, 12, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="differentiates W only"):
        tmm.layer0_dense_pair(x, torch.empty(12, 16, device="meta"), 0.5, None, True)


@pytest.mark.parametrize("key,ctr,want", [
    ((0, 0), (0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 4, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))])
def test_philox_known_answers(key, ctr, want):
    """Philox4x32-10's known-answer vectors (Random123, Salmon et al.)."""
    got = tmm.philox4x32(key, torch.tensor([ctr], dtype=torch.int64))[0]
    assert tuple(int(v) for v in got) == want


@pytest.mark.parametrize("rate,q,inv_q,pow2,thresh,bits", [
    (0.5, 0.5, 2.0, 1, 128, 8), (0.75, 0.25, 4.0, 1, 64, 8), (0.375, 0.625, 0.0, 0, 160, 8),
    (0.3, float(np.float32(0.7)), 0.0, 0, round(float(np.float32(0.7)) * 2**32), 32),
    (0.1, float(np.float32(0.9)), 0.0, 0, round(float(np.float32(0.9)) * 2**32), 32),
    (1.0, 0.0, 0.0, 0, 0, 8), (1e-12, 1.0, 1.0, 1, 256, 8)])
def test_dropout_keep(rate, q, inv_q, pow2, thresh, bits):
    """q = 1 - rate in f32 (as torch compares its uniforms), 1/q only where it
    is exact; 8 bits an element where q·2^8 is whole, else 32; the threshold
    q·2^bits: keep share q."""
    assert kernels.dropout_keep(rate) == (q, inv_q, pow2, thresh, bits)


@pytest.mark.parametrize("rate", [0.6, 0.5, 0.3, 0.1, 0.37, 0.999])
def test_division_by_q_in_f64_is_f32_division(rate):
    """The wide way divides by q = 1 - p as x times 1/q in f64, rounded once
    to f32: bit for bit x / q in f32 (as the other ways and the plain version
    divide), over every significand of the binade [1, 2), all the subnormals
    and zero, and random bit patterns up to the largest finite value."""
    q = np.float32(kernels.dropout_keep(rate)[0])
    rq = 1.0 / np.float64(q)
    sig = np.arange(2**23, dtype=np.uint32)
    rng = np.random.default_rng(int(rate * 1000))
    for bits in (np.uint32(127 << 23) | sig, sig,
                 rng.integers(0, 0x7F800000, 2**20, dtype=np.uint32)):
        x = np.concatenate([bits, bits | np.uint32(1 << 31)]).view(np.float32)
        with np.errstate(over="ignore"):
            want = x / q
            got = (x.astype(np.float64) * rq).astype(np.float32)
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1, 5, 64, 67, 602, 3703])
@pytest.mark.parametrize("rate", [0.5, 0.3])
def test_plain_version_drops_and_scales(f, rate, dtype):
    """Every xd value is 0 or x / (1 - p) correctly rounded (in f32, then to x's
    type); the keep share lies within 5 sigma of 1 - p; the products are those
    of xd and of x with W in x's type; the pair's mask is the train half's."""
    n = max(8, 40000 // f)
    x, w = _inputs(n, f, 16, dtype, seed=f)
    xd, zt, ze = tmm.layer0_pair_plain(x, w, SEEDS, rate, True)
    keep = tmm.layer0_keep(SEEDS.tolist(), n, f, rate)
    q = float(np.float32(1.0 - rate))
    assert torch.equal(xd, torch.where(keep, x.float() / q, torch.zeros(())).to(dtype))
    share, sigma = float(keep.double().mean()), (q * (1 - q) / keep.numel()) ** 0.5
    assert abs(share - q) < 5 * sigma
    wr = w.to(dtype).double()
    assert torch.equal(zt, (xd.double() @ wr).to(dtype))
    assert torch.equal(ze, (x.double() @ wr).to(dtype))
    assert torch.equal(tmm.layer0_pair_plain(x, w, SEEDS, rate, False)[0], xd)


def test_mask_follows_row_column_and_seeds():
    """A row's mask depends on its index, F and the seeds alone (not on how
    many rows follow); another key or offset draws another mask; and the 4
    columns of one draw are not alike."""
    base = tmm.layer0_keep(SEEDS.tolist(), 50, 602, 0.5)
    assert torch.equal(tmm.layer0_keep(SEEDS.tolist(), 20, 602, 0.5), base[:20])
    for other in ([SEEDS[0] + 1, SEEDS[1]], [SEEDS[0], SEEDS[1] + 1]):
        diff = (tmm.layer0_keep([int(v) for v in other], 50, 602, 0.5) != base).double().mean()
        assert 0.45 < float(diff) < 0.55
    cols = base[:, :600].reshape(50, 150, 4)
    assert 0.45 < float((cols[..., 0] != cols[..., 1]).double().mean()) < 0.55


def _plain_launch(x, w, seeds, rate, with_eval):
    return tmm.layer0_pair_plain(x, w, seeds, rate, with_eval)


@pytest.mark.parametrize("with_eval", [False, True])
@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)])
def test_function_saves_xd_alone_and_dw_is_xdt_g(monkeypatch, x_dtype, w_dtype, with_eval):
    """The kernel's autograd Function (the plain version launched in its place)
    saves exactly one tensor, xd, of x's shape, and nothing of [N, H]; W's
    gradient is xdᵀ·g in W's type, the plain product of the saved xd."""
    monkeypatch.setattr(kernels, "layer0_pair", _plain_launch)
    x, w = _inputs(45, 70, 16, x_dtype)
    w = w.to(w_dtype).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        out = tmm._Layer0Pair.apply(w, x, 0.5, torch.Generator().manual_seed(3), with_eval)
    zt = out[0] if with_eval else out
    assert [tuple(t.shape) for t in saved] == [(45, 70)] and saved[0].dtype == x_dtype
    xd = saved[0]
    assert not xd[x == 0].any() and 0.4 < float((xd[x != 0] != 0).double().mean()) < 0.6
    g = torch.randn(45, 16, generator=torch.Generator().manual_seed(4)).to(x_dtype)
    zt.backward(g)
    assert w.grad.dtype == w_dtype and torch.equal(w.grad, xd.t().mm(g).to(w_dtype))
    if with_eval:
        assert not out[1].requires_grad and out[1].shape == (45, 16)


def _small_graph(n):
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    pairs = np.unique(np.concatenate([np.stack([src, dst], 1), np.stack([dst, src], 1),
                                      np.stack([np.arange(n)] * 2, 1)]), axis=0)
    indptr = np.searchsorted(pairs[:, 0], np.arange(n + 1))
    return build_graph(tds.CSR(indptr, pairs[:, 1]), backend="ell", device="cpu")


@pytest.mark.parametrize("kernel_path", [False, True])
def test_a_training_step_saves_one_tensor_of_x_shape(monkeypatch, kernel_path):
    """The benchmark reads a step's layer-0 mask from the one float tensor of
    x's shape saved for the backward pass: a fused epoch's forward and
    backward save exactly one, on the CPU path and through the kernel's
    Function (the plain version launched in its place)."""
    n, f = 50, 30
    graph = _small_graph(n)
    x, _ = _inputs(n, f, 8, torch.float32)
    model = gcn.GCN((f, 8, 3), torch.Generator().manual_seed(0))
    if kernel_path:
        monkeypatch.setattr(kernels, "layer0_pair", _plain_launch)
        monkeypatch.setattr(gcn, "layer0_dense_pair", lambda x, w, rate, gen, training, **kw:
                            tmm._Layer0Pair.apply(w, x, rate, gen, kw.get("with_eval", False)))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append((tuple(t.shape), t.is_floating_point())) or t, lambda t: t):
        ht, he = model.apply_pair(graph, x, dropout_rate=0.5,
                                  generator=torch.Generator().manual_seed(2))
    ht.sum().backward()
    assert shapes.count(((n, f), True)) == 1
    assert model.w1.grad is not None and not he.requires_grad


@pytest.fixture
def c_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(kernels, "_call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(kernels, "_stream", lambda index: 7000 + index)
    return calls


class _Card(torch.Tensor):
    """A CPU tensor that answers as one on CUDA device 0."""

    is_cuda = True

    def get_device(self):
        return 0


def _card(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_Card)


@pytest.mark.parametrize("f,h,path,launches", [
    (12, 6, "flat", [(0, 6, 1)]), (12, 16, "flat", [(0, 16, 1)]),  # the parent's launches
    (12, 17, "wide", [(0, 17, 1)]), (12, 41, "wide", [(0, 41, 1)]),
    (12, 64, "wide", [(0, 64, 1)]), (12, 72, "wide", [(0, 64, 1), (64, 8, 0)]),
    (800, 17, "flat", [(0, 16, 1), (16, 1, 0)]),  # F = 800: W does not fit whole beside
    (800, 41, "flat", [(0, 16, 1), (16, 16, 0), (32, 9, 0)]),  # the wide way's stages
    (800, 64, "flat", [(0, 16, 1), (16, 16, 0), (32, 16, 0), (48, 16, 0)])])
def test_launcher_splits_w_in_launches_of_16_columns(c_calls, f, h, path, launches):
    """Up to 16 columns a call is one launch of the flat way, with the
    arguments it always had. Above 16 the wide way takes up to 64 columns a
    launch where W fits whole beside its stages; where it does not, the flat
    way takes one launch per 16 columns (W's past H zero-filled in the
    kernel). Only the first launch writes xd."""
    xd, zt, ze = kernels.layer0_pair(_card(60, f, dtype=torch.bfloat16), _card(f, h),
                                     _card(2, dtype=torch.int64), 0.3, False)
    assert ze is None and zt.shape == (60, h) and zt.dtype == xd.dtype == torch.bfloat16
    q, _, _, thresh, bits = kernels.dropout_keep(0.3)
    assert [(a[9], a[10], a[17]) for _, a in c_calls] == launches
    for _, a in c_calls:
        assert a[3:6] == (xd.data_ptr(), zt.data_ptr(), None) and a[6:9] == (60, f, h)
        assert a[11] == kernels.LAYER0_PATHS.index(path)
        assert a[12:17] == (q, 0.0, 0, thresh, bits) and a[18:] == (1, 7000)


@pytest.mark.parametrize("f,h,itemsize,with_eval,ptr,path", [
    (602, 16, 4, True, 0, "flat"),        # synth-reddit's pair: 226,880 bytes
    (602, 16, 4, False, 0, "flat"), (602, 16, 2, True, 0, "flat"), (500, 16, 4, True, 0, "flat"),
    (619, 16, 4, True, 0, "flat"), (620, 16, 4, True, 0, "chunked"),  # two blocks, W, the sums
    (671, 16, 4, False, 0, "flat"), (672, 16, 4, False, 0, "chunked"),
    (3703, 16, 4, True, 0, "chunked"),    # a block of 32 rows is 474 KB
    (1433, 16, 2, False, 0, "chunked"), (602, 16, 4, True, 8, "chunked"),  # x off 16 bytes
    (602, 64, 4, True, 0, "wide"),        # the GAT's layer 0: W 154,112 bytes, 221,696 in all
    (602, 64, 2, True, 0, "wide"), (602, 17, 4, False, 0, "wide"),
    (644, 64, 4, True, 0, "wide"), (645, 64, 4, True, 0, "chunked"),  # W beside 8 warps' stages
    (772, 64, 2, True, 0, "wide"), (773, 64, 2, True, 0, "flat"),
    (602, 64, 4, True, 8, "chunked"), (3703, 64, 4, True, 0, "chunked")])
def test_layer0_path_by_what_fits(f, h, itemsize, with_eval, ptr, path):
    """Above 16 columns the wide way takes W whole where it fits beside its
    warps' stages and x starts on 16 bytes; else, and at 16 columns and fewer,
    the flat way takes blocks of 32 whole rows where two blocks and W fit a
    CTA's shared memory and x starts on 16 bytes; else the chunked way."""
    assert kernels.layer0_path(f, h, itemsize, with_eval, ptr) == path
    aligned = ptr % 16 == 0
    wide = h > kernels.LAYER0_COLS and kernels.layer0_wide_smem(f, itemsize) <= kernels.SMEM_BLOCK_BYTES
    flat = kernels.layer0_flat_smem(f, itemsize, with_eval) <= kernels.SMEM_BLOCK_BYTES
    assert (path == "wide") == (aligned and wide)
    assert (path == "flat") == (aligned and flat and not wide)


@pytest.mark.parametrize("fault,error", [
    (dict(rate=0.0), ValueError), (dict(rate=1.5), ValueError),
    (dict(x=_card(60, 12, dtype=torch.float64)), TypeError),
    (dict(w=_card(12, 16, dtype=torch.bfloat16)), TypeError),
    (dict(seeds=_card(3, dtype=torch.int64)), ValueError), (dict(x=_card(60)), ValueError)])
def test_launcher_refuses(c_calls, fault, error):
    args = dict(x=_card(60, 12), w=_card(12, 16), seeds=_card(2, dtype=torch.int64), rate=0.5,
                with_eval=True)
    args.update(fault)
    with pytest.raises(error):
        kernels.layer0_pair(**args)
    assert c_calls == []


def test_launcher_without_columns_or_features(c_calls):
    """No feature: the products are zeros, with no launch; no row: empty."""
    _, zt, ze = kernels.layer0_pair(_card(5, 0), _card(0, 16), _card(2, dtype=torch.int64),
                                    0.5, True)
    assert not zt.any() and not ze.any() and zt.shape == (5, 16)
    xd, zt, _ = kernels.layer0_pair(_card(0, 12), _card(12, 16), _card(2, dtype=torch.int64),
                                    0.5, False)
    assert xd.shape == (0, 12) and zt.shape == (0, 16) and c_calls == []


def test_chip_smoke_edges_take_both_ways():
    """The card check's edge cases reach all three ways through x: the flat
    one (a block of 32 rows as one range), the chunked one (F past what fits,
    or x off 16 bytes) and the wide one (above 16 columns)."""
    import chip_smoke

    ways = set()
    for n, f, h, dtype, rate, offset in chip_smoke.LAYER0_EDGES:
        item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
        ways.add(kernels.layer0_path(f, h, item, True, offset * item))
    assert ways == {"flat", "chunked", "wide"}


@pytest.mark.parametrize("fault", ["none", "scale", "where_x_is_0", "mask"])
def test_chip_smoke_check_reads_every_row(monkeypatch, fault):
    """The card check holds every row of xd: with the plain version in the
    kernel's place it passes, and one wrong value in the last row (a wrong
    scale, a value where x is 0, a dropped value the mask keeps) fails it."""
    import chip_smoke

    def launch(x, w, seeds, rate, with_eval):
        xd, zt, ze = tmm.layer0_pair_plain(x, w, seeds, rate, with_eval)
        row, col = xd[-1], x[-1]
        if fault == "scale":
            row[col != 0] *= 1.5
        elif fault == "where_x_is_0":
            row[col == 0] = 1.0
        elif fault == "mask":
            row[row != 0] = 0.0
        return xd, zt, ze

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(kernels, "layer0_pair", launch)
    x, w = _inputs(1000, 67, 16, torch.float32)
    x[-1, :4] = 1.0  # the last row keeps a value at this seed
    if fault == "none":
        chip_smoke._layer0_check("plain", x, w, SEEDS, 0.5)
    else:
        with pytest.raises(AssertionError, match="xd"):
            chip_smoke._layer0_check(fault, x, w, SEEDS, 0.5)
