"""The dynamic-gather probes' plain versions against the TPU scripts' kernels.

``sublane_kernel`` and ``lane_kernel`` are module-level in
scripts/exp_dyngather.py (:38, :54): they are loaded from the script by path
and run through ``pl.pallas_call(..., interpret=True)`` on the CPU. The bodies
k1..k5 of scripts/exp_dyngather2.py (:53-101) and ``try_taa``'s body
(scripts/exp_dyngather3.py:27) are closures inside a main that needs a TPU, so
they are restated with the same jnp expressions. Every comparison is exact: a
gather moves values, and the sums add the same f32 values in the same order
(a bf16 table is widened to f32 before each addition on both sides).
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cuda_gcn_torch.probes import dyngather as dg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "exp_dyngather", os.path.join(ROOT, "scripts", "exp_dyngather.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def to_jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def interpret(kernel, steps, idx, tab):
    f = pl.pallas_call(functools.partial(kernel, steps), interpret=True,
                       out_shape=jax.ShapeDtypeStruct(tab.shape, jnp.float32))
    return np.asarray(f(to_jnp(idx), to_jnp(tab)))


@pytest.mark.parametrize("i", range(7))
def test_forms_match_the_scripts_pallas_kernels(script, i):
    """The four sublane and three lane cases of the script, S (or L) cut 64-fold."""
    case = dg.forms_cases("cpu", scale=64)[i]
    kernel = script.sublane_kernel if case.axis == 0 else script.lane_kernel
    got = case.run()
    assert got.dtype == torch.float32 and got.shape == case.tab.shape
    np.testing.assert_array_equal(got.numpy(),
                                  interpret(kernel, case.steps, case.idx, case.tab))
    named = dg.sublane_gather if case.axis == 0 else dg.lane_gather
    np.testing.assert_array_equal(named(case.idx, case.tab).numpy(), got.numpy())


def _bisect_bodies(steps):
    def k3(idx, tab):
        acc = jnp.zeros(tab.shape, jnp.float32)
        for k in range(steps):
            acc = acc + jnp.take_along_axis(
                tab, jnp.broadcast_to(idx[:, k][:, None], tab.shape), axis=0)
        return acc

    return [lambda idx, tab: jnp.take_along_axis(tab, idx, axis=0),
            lambda idx, tab: jnp.take_along_axis(tab, jnp.broadcast_to(idx, tab.shape), axis=0),
            k3,
            lambda idx, tab: jnp.take_along_axis(tab, idx, axis=1),
            lambda idx, tab: jnp.take(tab, idx, axis=0)]


@pytest.mark.parametrize("i", range(5))
def test_bisect_forms_match_the_jnp_bodies(i):
    case = dg.bisect_cases("cpu", s=128, l=128, s2=8, l2=256)[i]
    want = _bisect_bodies(dg.BISECT_STEPS)[i](to_jnp(case.idx), to_jnp(case.tab))
    np.testing.assert_array_equal(case.run().numpy(), np.asarray(want))


@pytest.mark.parametrize("i", range(len(dg.ENVELOPE_SHAPES)))
def test_envelope_matches_the_jnp_body(i):
    """exp_dyngather3's shapes as they are (S from 8, L 128 to 2048), 3 repeats."""
    case = dg.envelope_cases("cpu", reps=3)[i]
    idx, tab = to_jnp(case.idx), to_jnp(case.tab)
    acc = jnp.zeros(tab.shape, jnp.float32)
    for _ in range(3):
        acc = acc + jnp.take_along_axis(tab, idx, axis=case.axis).astype(jnp.float32)
    np.testing.assert_array_equal(case.run().numpy(), np.asarray(acc))
    assert case.label.startswith(f"TAA axis{case.axis} [{tab.shape[0]}x{tab.shape[1]}]")


def test_cases_list_every_shape_of_the_scripts():
    forms = dg.forms_cases("cpu", scale=64)
    assert [(c.tab.shape[0] * (64 if c.axis == 0 else 1),
             c.tab.shape[1] * (1 if c.axis == 0 else 64),
             str(c.tab.dtype).split(".")[1], c.steps) for c in forms] == [
        *dg.SUBLANE_SHAPES, *dg.LANE_SHAPES]
    assert [c.form for c in dg.bisect_cases("cpu", 128, 128, 8, 256)] == [
        "full_rows", "bcast_rows", "compact_rows", "full_lanes", "take_rows"]
    assert all(c.reps == dg.ENVELOPE_REPS == 32 for c in dg.envelope_cases("cpu"))
    line = dg.rate_line(forms[0], 0.5)
    assert "ns/row" in line and "GB/s" in line
    assert "ns/col" in dg.rate_line(forms[-1], 0.5)
    assert "ns/elem" in dg.rate_line(dg.envelope_cases("cpu")[0], 0.5)


def test_a_wrong_index_shape_raises_and_so_does_a_run_without_a_card(monkeypatch):
    tab = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="takes idx"):
        dg.gather("full_rows", torch.zeros(16, 1, dtype=torch.int32), tab)
    with pytest.raises(ValueError, match="unknown form"):
        dg.gather("rows", torch.zeros(16, 128, dtype=torch.int32), tab)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        dg.run("bisect")
