"""The probe kernels' plain versions against numpy restatements of the TPU
probe bodies.

``gather_kernel`` and ``scatter_kernel`` (scripts/exp_pallas_gather.py:60-70
and :85-95) are closures inside the script's main and need a TPU, so their
loops are restated here in numpy: probe A sums the gathered rows chunk by
chunk (512 ids a step; m is a multiple of 512), probe B adds coef[i] ·
h[i mod rows] into row idx[i] one i at a time. Tolerances: probe A atol 1e-4,
rtol 1e-5 (a sum of m rows of unit normals, only the order differs); probe B
exact, since it adds in the order of the TPU loop.

The card's probe A counts, then contracts (csrc/gather_probe.cu): Σ_i h[idx[i]]
= Σ_r count[r] · h[r]. That regrouping is restated in plain torch (bincount,
then a pairwise sum of the products) and held to the TPU loop at the
tolerance chip_smoke (i) holds the kernel to, 1e-6 of Σ_i |h[idx[i]]|.

The card's probe B adds each row in one warp, the rows of a tile of ids
(``scatter_split_plain``): that split is held to the TPU loop bit for bit and
checked to cover every row and term once. Its plain version adds in index
order whatever the order of the ids; the kernel takes sorted ids only.
"""

import numpy as np
import pytest
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.probes import gather as tprobe

CH = 512  # exp_pallas_gather.py:57


def gather_restated(idx, h):
    acc = np.zeros(h.shape[1], np.float32)
    for i in range(len(idx) // CH):
        acc = acc + h[idx[i * CH:(i + 1) * CH]].sum(0)
    return acc[None]


def scatter_restated(idx, coef, h, mb):
    out = np.zeros_like(h)
    for i in range(mb):
        out[idx[i]] += coef[i] * h[i % h.shape[0]]
    return out


@pytest.mark.parametrize("rows,m,d", [(256, 8192, 128), (1000, 4096, 41)])
def test_gather_probe_plain_matches_the_tpu_loop(rows, m, d):
    x = tprobe.make_inputs(rows, m, d, seed=rows)
    got = tprobe.gather_probe(x["idx"], x["h"])
    assert got.shape == (1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), gather_restated(x["idx"].numpy(), x["h"].numpy()),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,m,d", [(256, 8192, 128), (1000, 4096, 41)])
def test_scatter_probe_plain_matches_the_tpu_loop(rows, m, d):
    x = tprobe.make_inputs(rows, m, d, seed=rows)
    mb = min(m, tprobe.SCATTER_MAX) // 2
    got = tprobe.scatter_probe(x["idx_sorted"], x["coef"], x["h"], mb)
    want = scatter_restated(x["idx_sorted"].numpy(), x["coef"].numpy(), x["h"].numpy(), mb)
    assert got.shape == (rows, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_inputs_follow_the_script():
    """Sorted ids are the random ids sorted; ids fall in the table."""
    x = tprobe.make_inputs(64, 4096, 8, seed=0)
    assert x["idx"].dtype == torch.int32 and x["h"].shape == (64, 8)
    np.testing.assert_array_equal(x["idx_sorted"].numpy(), np.sort(x["idx"].numpy()))
    assert 0 <= int(x["idx"].min()) and int(x["idx"].max()) < 64
    assert tprobe.SCATTER_MAX == 1 << 16


def count_then_contract(idx, h):
    """Probe A as the card's kernel regroups it: count[r] = #{i: idx[i] = r},
    then Σ_r count[r] · h[r] summed pairwise (halves added until one row is
    left), in f32."""
    counts = torch.bincount(idx.long(), minlength=h.shape[0]).to(torch.float32)
    terms = counts[:, None] * h
    while terms.shape[0] > 1:
        if terms.shape[0] % 2:
            terms = torch.cat([terms, torch.zeros_like(terms[:1])])
        terms = terms[0::2] + terms[1::2]
    return terms


@pytest.mark.parametrize("case", ["rows 16384", "one row", "above shared memory"])
def test_count_then_contract_matches_the_tpu_loop(case):
    """The three shapes of the kernel's paths: 16384 rows (shared-memory
    counts), every id in one row, and a table whose counts exceed a block's
    shared memory (global counts); d 32, m 2^18. Held to the TPU loop in f64
    and, for random ids, in f32. With every id in one row the f32 loop is the
    inexact side: its chain of 512 chunk sums of one value drifts by 1.1e-5 of
    Σ|terms| from the exact m · h[r], which the regrouped sum gives exactly."""
    rows = {"rows 16384": 16384, "one row": 1000, "above shared memory": 1 << 16}[case]
    x = tprobe.make_inputs(rows, 1 << 18, 32, seed=rows)
    idx, h = x["idx"], x["h"]
    if case == "one row":
        idx = torch.full_like(idx, 617)
    got = count_then_contract(idx, h).numpy().astype(np.float64)
    assert got.shape == (1, 32)
    idx_n, h_n = idx.numpy(), h.numpy()
    mass = gather_restated(idx_n, np.abs(h_n).astype(np.float64))
    tol = 1e-6 * mass
    assert (np.abs(got - gather_restated(idx_n, h_n.astype(np.float64))) <= tol).all()
    if case != "one row":
        assert (np.abs(got - gather_restated(idx_n, h_n)) <= tol).all()
    # and the plain version, which the kernel is held to on the card
    assert (np.abs(got - tprobe.gather_probe_plain(idx, h).numpy()) <= tol).all()


@pytest.mark.parametrize("bad", [64, -65])
def test_the_plain_probe_a_refuses_an_id_outside_the_table(bad):
    """Such an id makes the card's result NaN (chip_smoke (i)); the plain
    version, indexing as torch does, raises."""
    x = tprobe.make_inputs(64, 1000, 8, seed=3)
    idx = x["idx"].clone()
    idx[7] = bad
    with pytest.raises(IndexError):
        tprobe.gather_probe(idx, x["h"])


def _scatter_case(case):
    """(idx, coef, h, mb) of a split case: the probe's defaults at d 128 (mb
    65,536: 1,021 busy rows), d 41, every term in one row, mb 0 and 1, mb
    not a multiple of the tiles, and ids only in the last row."""
    rows, m, d, mb = {"defaults": (16384, 1 << 20, 128, 1 << 16), "d 41": (1000, 4096, 41, 2048),
                      "one row": (1000, 4096, 16, 4096), "mb 0": (300, 64, 8, 0),
                      "mb 1": (300, 64, 8, 1), "ragged share": (1009, 3001, 8, 2999),
                      "last row only": (700, 4096, 8, 4096)}[case]
    x = tprobe.make_inputs(rows, m, d, seed=0 if case == "defaults" else rows)  # run()'s seed
    idx = x["idx_sorted"].numpy()
    if case == "one row":
        idx = np.full_like(idx, 617)
    elif case == "last row only":
        idx = np.full_like(idx, rows - 1)
    return idx, x["coef"].numpy(), x["h"].numpy(), mb


def scatter_by_split(idx, coef, h, mb, ctas):
    """Probe B as its kernel computes it: every row 0, then each tile of
    ``scatter_split_plain`` adds its rows' terms in index order, the product
    and the sum rounded apart in f32."""
    rows = h.shape[0]
    out = np.zeros_like(h)
    for lo, hi in tprobe.scatter_split_plain(idx, mb, rows, ctas):
        for j in range(lo, hi):
            out[idx[j]] += coef[j] * h[j % rows]
    return out


SPLIT_CASES = ["defaults", "d 41", "one row", "mb 0", "mb 1", "ragged share", "last row only"]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_scatter_split_sums_as_the_tpu_loop(case):
    """The kernel's work split and per-row order give the TPU loop's bits."""
    idx, coef, h, mb = _scatter_case(case)
    np.testing.assert_array_equal(scatter_by_split(idx, coef, h, mb, kernels.SCATTER_CTAS),
                                  scatter_restated(idx, coef, h, mb))


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_scatter_split_covers_every_row_and_term_once(case):
    """The tiles' ranges of terms are consecutive and cover [0, mb) once; each
    starts at a row's first term and ends at a row's last, so no row is cut
    and every row with a term is added by one tile. No tile holds more terms
    than its share and one row. At the defaults the busy rows spread over
    every CTA."""
    idx, coef, h, mb = _scatter_case(case)
    rows, ctas = h.shape[0], kernels.SCATTER_CTAS
    split = tprobe.scatter_split_plain(idx, mb, rows, ctas)
    tiles = max(ctas, -(-mb // kernels.SCATTER_TILE_IDS))
    assert split.shape == (tiles, 2) and split[0, 0] == 0 and split[-1, 1] == mb
    np.testing.assert_array_equal(split[1:, 0], split[:-1, 1])
    ids = idx[:mb]
    edges = np.r_[np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]]), mb] if mb else [0]
    assert np.isin(split, edges).all()
    counts = np.bincount(ids, minlength=rows) if mb else np.zeros(rows, np.int64)
    share = max(1, -(-mb // tiles))
    assert (split[:, 1] - split[:, 0]).max() <= share + counts.max()
    if case == "defaults":
        assert (counts > 0).sum() == 1021 and share <= kernels.SCATTER_TILE_IDS
        assert (split[:, 1] > split[:, 0]).all()


@pytest.mark.parametrize("mb,ctas,tiles", [
    (1 << 16, 132, 132), (2048, 132, 132), (0, 132, 132), (1 << 20, 132, 512),
    ((1 << 20) + 1, 264, 513)])
def test_scatter_tiles_hold_at_most_2048_ids(mb, ctas, tiles):
    """As many tiles as CTAs, or more where a tile would pass the 2048 ids
    the kernel's shared memory holds."""
    split = tprobe.scatter_split_plain(np.zeros(mb, np.int32), mb, 7, ctas)
    assert split.shape == (tiles, 2)
    assert -(-mb // tiles) <= kernels.SCATTER_TILE_IDS


def test_the_plain_probe_b_sums_unsorted_ids_as_the_tpu_loop():
    """A swapped pair and random ids: the plain version adds in index order,
    as the TPU loop does (the card's kernel writes NaN for them, chip_smoke
    (i))."""
    x = tprobe.make_inputs(1000, 4096, 41, seed=5)
    h, coef = x["h"], x["coef"]
    swapped = x["idx_sorted"].clone()
    swapped[[100, 3000]] = swapped[[3000, 100]]
    for idx in (swapped, x["idx"]):
        got = tprobe.scatter_probe(idx, coef, h, 4096)
        np.testing.assert_array_equal(
            got.numpy(), scatter_restated(idx.numpy(), coef.numpy(), h.numpy(), 4096))


@pytest.mark.parametrize("bad", [1000, -1])
def test_the_plain_probe_b_refuses_an_id_outside_the_table(bad):
    """The card's kernel writes NaN for such an id (chip_smoke (i)); the plain
    version raises."""
    x = tprobe.make_inputs(1000, 4096, 8, seed=6)
    idx = x["idx_sorted"].clone()
    idx[2000] = bad
    with pytest.raises((IndexError, RuntimeError)):
        tprobe.scatter_probe(idx, x["coef"], x["h"], 4096)
