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
"""

import numpy as np
import pytest
import torch

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
