"""The take-along-axis probes' plain versions against the TPU script's bodies.

``taa_kernel``, ``cumsum_kernel`` and ``piece_kernel``
(scripts/exp_pallas_taa.py:77,98,117) are closures inside the script's main
and need a TPU, so their bodies are restated here with the same jnp
expressions on the CPU (``jnp.take_along_axis`` over a broadcast index,
``jnp.cumsum``, the ``fori_loop`` as a Python loop). Tolerances: the gather
adds the same f32 values in the same order and is exact; the scan and the
piece are held to ``taa.scan_tolerance`` (√S · f32 epsilon · max|cs| per rep),
since only the order of a scan's additions differs. The kernels' own order,
``taa.scan_order_plain``, is held to the bodies and to an f64 scan the same
way, at shapes off the kernels' tiles (S not a multiple of 128 rows, L not a
multiple of 4 or of 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cuda_gcn_torch import kernels
from cuda_gcn_torch.probes import taa

L = taa.LANES


def jnp_inputs(x):
    return {k: jnp.asarray(v.numpy()) for k, v in x.items()}


def taa_body(ids, tab, reps):
    s = tab.shape[0]
    idx = jnp.broadcast_to(ids, (s, L))
    acc = jnp.zeros((s, L), jnp.float32)
    for _ in range(reps):
        acc = acc + jnp.take_along_axis(tab, idx, axis=0)
    return acc


def cumsum_body(tab, reps):
    acc = jnp.zeros(tab.shape, jnp.float32)
    for _ in range(reps):
        acc = acc + jnp.cumsum(tab + acc * 0, axis=0)
    return acc


def piece_body(ids, coef, begin, end, tab, reps):
    s, lanes = tab.shape
    idx, bidx, eidx = (jnp.broadcast_to(a, (s, lanes)) for a in (ids, begin, end))
    acc = jnp.zeros((s, lanes), jnp.float32)
    for _ in range(reps):
        vals = jnp.take_along_axis(tab, idx, axis=0) * coef
        cs = jnp.cumsum(vals, axis=0)
        csz = jnp.concatenate([jnp.zeros((1, lanes), jnp.float32), cs], axis=0)[:s + 1]
        acc = acc + (jnp.take_along_axis(csz, eidx, axis=0)
                     - jnp.take_along_axis(csz, bidx, axis=0))
    return acc


@pytest.mark.parametrize("s,reps", [(64, 1), (512, 2)])
def test_taa_probe_plain_matches_the_tpu_body(s, reps):
    x = taa.make_inputs(s, seed=s)
    j = jnp_inputs(x)
    got = taa.taa_probe(x["ids"], x["tab"], reps)
    assert got.shape == (s, L) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(taa_body(j["ids"], j["tab"], reps)))


@pytest.mark.parametrize("s,reps", [(64, 1), (512, 2)])
def test_cumsum_probe_plain_matches_the_tpu_body(s, reps):
    x = taa.make_inputs(s, seed=s)
    want = np.asarray(cumsum_body(jnp.asarray(x["tab"].numpy()), reps))
    got = taa.cumsum_probe(x["tab"], reps).numpy()
    tol = taa.scan_tolerance(float(np.abs(want).max()) / reps, s, reps)
    assert np.abs(got - want).max() <= tol
    assert tol < 2e-4 * reps  # tight at this size: values reach about 60


@pytest.mark.parametrize("s,reps", [(64, 1), (512, 2)])
def test_piece_probe_plain_matches_the_tpu_body(s, reps):
    x = taa.make_inputs(s, seed=s)
    j = jnp_inputs(x)
    want = np.asarray(piece_body(j["ids"], j["coef"], j["begin"], j["end"], j["tab"], reps))
    got = taa.piece_probe(x["ids"], x["coef"], x["begin"], x["end"], x["tab"], reps).numpy()
    cs_max = float(taa.piece_scan(x["ids"], x["coef"], x["tab"]).abs().max())
    assert np.abs(got - want).max() <= taa.scan_tolerance(cs_max, s, reps)
    # the piece is a sorted segment sum: the library's gather and index_add_ agree
    seg = taa.gather_segment_library(x["ids"], x["coef"], x["rows_sorted"].long(), x["tab"])
    np.testing.assert_allclose(got, reps * seg.numpy(), rtol=1e-4, atol=1e-4)


def test_piece_boundaries_cover_empty_segments_and_the_last_row():
    """begin == end gives a zero row; end == S reads the scan's last row."""
    s = 64
    x = taa.make_inputs(s, seed=3)
    begin, end = x["begin"].clone(), x["end"].clone()
    assert bool((x["begin"] == x["end"]).any()) and int(x["end"].max()) == s
    begin[5], end[5] = 7, 7
    begin[6], end[6] = 0, s
    got = taa.piece_probe(x["ids"], x["coef"], begin, end, x["tab"])
    cs = taa.piece_scan(x["ids"], x["coef"], x["tab"])
    assert cs.shape == (s + 1, L) and not cs[0].any()
    assert not got[5].any()
    np.testing.assert_array_equal(got[6].numpy(), cs[s].numpy())
    j = jnp_inputs(dict(x, begin=begin, end=end))
    want = np.asarray(piece_body(j["ids"], j["coef"], j["begin"], j["end"], j["tab"], 1))
    assert np.abs(got.numpy() - want).max() <= taa.scan_tolerance(float(cs.abs().max()), s, 1)


def _table(s, l, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((s, l)).astype(np.float32))


def _loop_order(vals):
    """``scan_order_plain``'s order written out element by element in numpy f32."""
    v = vals.numpy()
    s, l = v.shape
    rows, run = kernels.SCAN_CHUNK_ROWS, kernels.SCAN_WARP_ROWS
    out = np.zeros_like(v)
    fold = np.zeros(l, np.float32)
    for c0 in range(0, s, rows):
        x = np.zeros((rows, l), np.float32)
        x[:min(rows, s - c0)] = v[c0:c0 + rows]
        chunk = np.zeros_like(x)
        acc = None
        for w0 in range(0, rows, run):
            part = np.zeros((run, l), np.float32)
            part[0] = x[w0]
            for u in range(1, run):
                part[u] = part[u - 1] + x[w0 + u]
            chunk[w0:w0 + run] = part if acc is None else acc + part
            acc = part[-1] if acc is None else acc + part[-1]
        n = min(rows, s - c0)
        out[c0:c0 + n] = fold + chunk[:n]
        fold = fold + acc
    return out


@pytest.mark.parametrize("s,l", [(1, 1), (63, 5), (65, 127), (300, 3), (257, 130)])
def test_scan_order_plain_is_the_kernels_order(s, l):
    """The restated order equals the same additions made one by one, bit for bit."""
    vals = _table(s, l, s + l)
    np.testing.assert_array_equal(taa.scan_order_plain(vals).numpy(), _loop_order(vals))


@pytest.mark.parametrize("s,l", [(1, 1), (63, 5), (65, 127), (129, 128), (300, 333),
                                 (1000, 128), (4099, 4)])
def test_scan_order_plain_against_an_f64_scan(s, l):
    vals = _table(s, l, s)
    want = torch.cumsum(vals.double(), 0)
    got = taa.scan_order_plain(vals)
    assert got.dtype == torch.float32 and got.shape == (s, l)
    tol = taa.scan_tolerance(float(want.abs().max()), s, 1)
    assert float((got.double() - want).abs().max()) <= tol


@pytest.mark.parametrize("s,l,reps", [(1, 1, 1), (63, 5, 3), (65, 127, 1), (200, 333, 3),
                                      (129, 128, 2)])
def test_cumsum_off_the_tiles_matches_the_tpu_body(s, l, reps):
    """The plain version and the kernels' order against ``cumsum_kernel``'s body
    at shapes that cut the kernels' tiles: S past a whole chunk, L not a
    multiple of 4, reps > 1."""
    tab = _table(s, l, 7 * s + l)
    want = np.asarray(cumsum_body(jnp.asarray(tab.numpy()), reps))
    tol = taa.scan_tolerance(float(np.abs(want).max()) / reps, s, reps)
    for got in (taa.cumsum_probe(tab, reps), taa._repeat_add(taa.scan_order_plain(tab), reps)):
        assert got.shape == (s, l) and np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("s,l,reps", [(1, 1, 1), (63, 5, 3), (65, 127, 2), (200, 333, 3)])
def test_piece_off_the_tiles_matches_the_tpu_body(s, l, reps):
    """The piece at the same shapes, with the boundaries of (j)'s edge cases
    (in any order, empty segments, end == S); the kernels' scan order gives
    the same."""
    rng = np.random.default_rng(s + l)
    tab = _table(s, l, s)
    ids = torch.from_numpy(rng.integers(0, s, (s, 1)).astype(np.int32))
    coef = torch.from_numpy(rng.random((s, 1), dtype=np.float32))
    begin, end = (torch.from_numpy(a[:, None])
                  for a in chip_smoke._scan_boundaries(s, np.random.default_rng(s)))
    want = np.asarray(piece_body(*(jnp.asarray(a.numpy()) for a in (ids, coef, begin, end, tab)),
                                 reps))
    cs = taa.piece_scan(ids, coef, tab)
    tol = taa.scan_tolerance(float(cs.abs().max()), s, reps)
    got = taa.piece_probe(ids, coef, begin, end, tab, reps)
    assert got.shape == (s, l) and np.abs(got.numpy() - want).max() <= tol
    vals = tab[ids.reshape(-1).long()] * coef
    cs_order = torch.cat([torch.zeros(1, l), taa.scan_order_plain(vals)])
    b, e = begin.reshape(-1).long(), end.reshape(-1).long()
    ordered = taa._repeat_add(cs_order[e] - cs_order[b], reps)
    assert np.abs(ordered.numpy() - want).max() <= tol
    assert not got[::5].any() and not ordered[::5].any()


def test_probe_inputs_follow_the_script():
    x = taa.make_inputs(256, seed=0)
    assert x["tab"].shape == (256, L) and x["ids"].shape == (256, 1)
    assert x["ids"].dtype == x["begin"].dtype == x["end"].dtype == torch.int32
    ids, rows = x["ids"].numpy()[:, 0], x["rows_sorted"].numpy()
    assert (np.diff(ids) >= 0).all() and (np.diff(rows) >= 0).all()
    # segment r holds the positions whose sorted row is r
    np.testing.assert_array_equal(x["end"].numpy()[:, 0] - x["begin"].numpy()[:, 0],
                                  np.bincount(rows, minlength=256))
    assert 0 <= float(x["coef"].min()) and float(x["coef"].max()) < 1


def test_strided_index_forms_agree():
    """One index per row read through strides (1, 0, 0) equals the same index
    written out in full with strides (L, 1, 0), along both axes."""
    rng = np.random.default_rng(1)
    tab = torch.from_numpy(rng.standard_normal((32, L)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 32, (32, 1), dtype=np.int32))
    full = ids.expand(32, L).contiguous()
    np.testing.assert_array_equal(taa.taa_rows(ids, (1, 0, 0), tab, 1, 3).numpy(),
                                  taa.taa_rows(full, (L, 1, 0), tab, 1, 3).numpy())
    cols = torch.from_numpy(rng.integers(0, L, (2, L), dtype=np.int32))
    got = taa.taa_lanes(cols, (0, 1, L), tab, 2)
    want = tab[:, cols[0].long()] + tab[:, cols[1].long()]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        taa.run(s=64)
