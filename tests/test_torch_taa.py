"""The take-along-axis probes' plain versions against the TPU script's bodies.

``taa_kernel``, ``cumsum_kernel`` and ``piece_kernel``
(scripts/exp_pallas_taa.py:77,98,117) are closures inside the script's main
and need a TPU, so their bodies are restated here with the same jnp
expressions on the CPU (``jnp.take_along_axis`` over a broadcast index,
``jnp.cumsum``, the ``fori_loop`` as a Python loop). Tolerances: the gather
adds the same f32 values in the same order and is exact; the scan and the
piece are held to ``taa.scan_tolerance`` (√S · f32 epsilon · max|cs| per rep),
since only the order of a scan's additions differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    s = tab.shape[0]
    idx, bidx, eidx = (jnp.broadcast_to(a, (s, L)) for a in (ids, begin, end))
    acc = jnp.zeros((s, L), jnp.float32)
    for _ in range(reps):
        vals = jnp.take_along_axis(tab, idx, axis=0) * coef
        cs = jnp.cumsum(vals, axis=0)
        csz = jnp.concatenate([jnp.zeros((1, L), jnp.float32), cs], axis=0)[:s + 1]
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
