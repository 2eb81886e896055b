"""The probe kernels' plain versions against numpy restatements of the TPU
probe bodies.

``gather_kernel`` and ``scatter_kernel`` (scripts/exp_pallas_gather.py:60-70
and :85-95) are closures inside the script's main and need a TPU, so their
loops are restated here in numpy: probe A sums the gathered rows chunk by
chunk (512 ids a step; m is a multiple of 512), probe B adds coef[i] ·
h[i mod rows] into row idx[i] one i at a time. Tolerances: probe A atol 1e-4,
rtol 1e-5 (a sum of m rows of unit normals, only the order differs); probe B
exact, since it adds in the order of the TPU loop.
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
