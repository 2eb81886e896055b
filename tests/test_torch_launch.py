"""The launch path of the port's kernels, as far as the CPU can follow it.

What the launchers decide in Python is tested as plain functions: the load
width of kernels 2 and 3 from the feature width and the bases' alignment, and
the form of ``taa_rows`` from the strides, for every layout the probes use.
The launchers themselves are driven with tensors that claim to lie on a card
(``FakeCuda``, a Tensor subclass whose storage is on the CPU) and with the C
call replaced by a recorder: a valid call reaches the C function once, with
the arguments the kernel expects, and a wrong device, type, shape or a
non-contiguous operand is refused before it.
"""

import numpy as np
import pytest
import torch

from cuda_gcn_torch import kernels
from cuda_gcn_torch.ops import ell as tell
from cuda_gcn_torch.probes import dyngather as dg
from cuda_gcn_torch.probes import taa

I32 = torch.int32


@pytest.mark.parametrize("d,bases,vec", [
    (16, (0, 0, 0), 4), (32, (256, 512, 0), 4), (82, (0, 0, 0), 2), (6, (0, 0, 0), 2),
    (41, (0, 0, 0), 1), (3, (0, 0, 0), 1), (1, (0, 0, 0), 1),
    (16, (0, 8, 0), 2),     # out is 8-byte aligned only
    (16, (0, 0, 4), 1),     # the partials are 4-byte aligned only
    (82, (8, 8, 8), 2), (82, (8, 4, 8), 1), (128, (16, 32, 48), 4)])
def test_spmm_load_width_from_width_and_alignment(d, bases, vec):
    """The widest load whose size divides a row of d floats and every base."""
    assert kernels.spmm_vec(d, *bases) == vec
    assert d % vec == 0 and not any(b % (4 * vec) for b in bases)


def _probe_cases():
    x = taa.make_inputs(64)
    a2 = dg.Case("taa", "A2", "bcast_rows", x["ids"], x["tab"], 16)
    return [a2, *dg.forms_cases("cpu", scale=64), *dg.bisect_cases("cpu", 128, 128, 8, 256),
            *dg.envelope_cases("cpu")]


_WANT = {"compact_rows": "row", "bcast_rows": "row", "take_rows": "row",
         "full_rows": "general"}


@pytest.mark.parametrize("i", range(20))
def test_taa_rows_form_of_every_probe_layout(i):
    """A2 and the 19 cases of the dynamic-gather scripts: one index per row or
    per row and step is the row form, a full index the general form; the axis-1
    cases go to ``taa_lanes``, which has one form."""
    case = _probe_cases()[i]
    s, l = case.tab.shape
    if case.axis == 1:
        assert case.form in ("full_lanes", "compact_lanes")
        return
    form = kernels.taa_rows_form(case.strides, s, l, case.steps, case.idx.numel(),
                                 case.tab.element_size())
    assert form == _WANT[case.form]
    # the strides at the script's full size choose the same form
    full = {"compact_rows": (case.steps, 0, 1), "full_rows": (l, 1, 0)}.get(
        case.form, (1, 0, 0))
    assert case.strides == full


def test_the_20_probe_layouts_are_the_scripts():
    cases = _probe_cases()
    assert len(cases) == 20 and sum(c.axis == 0 for c in cases) == 14


@pytest.mark.parametrize("strides,s,l,steps,ptrs,form", [
    ((1, 0, 0), 64, 128, 1, (0, 0), "row"),
    ((64, 0, 1), 64, 128, 64, (0, 0), "row"),
    ((0, 0, 1), 64, 128, 3, (0, 0), "row"),            # the same rows for every output row
    ((128, 1, 0), 64, 128, 1, (0, 0), "general"),      # a full index
    ((256, 2, 0), 64, 128, 1, (0, 0), "general"),      # every other index
    ((1, 0, 0), 64, 130, 1, (0, 0), "general"),        # a row is no whole 4-column groups
    ((1, 0, 0), 64, 128, 1, (8, 0), "general"),        # f32 table 8-byte aligned only
    ((1, 0, 0), 64, 128, 1, (0, 8), "general"),        # out 8-byte aligned only
    ((1, 0, 0), 1 << 24, 128, 1, (0, 0), "general"),   # 2^31 table elements
])
def test_taa_rows_form_from_strides_and_alignment(strides, s, l, steps, ptrs, form):
    n_idx = (s - 1) * strides[0] + (l - 1) * strides[1] + (steps - 1) * strides[2] + 1
    assert kernels.taa_rows_form(strides, s, l, steps, n_idx, 4, *ptrs) == form


def test_taa_rows_form_bf16_rows_need_8_bytes():
    assert kernels.taa_rows_form((1, 0, 0), 64, 128, 1, 64, 2, 8, 0) == "row"
    assert kernels.taa_rows_form((1, 0, 0), 64, 128, 1, 64, 2, 4, 0) == "general"
    assert kernels.taa_rows_form((1, 0, 0), 64, 128, 1, 2**31, 2, 8, 0) == "general"
    assert kernels.TAA_FORMS == ("general", "row")


class FakeCuda(torch.Tensor):
    """A tensor on the CPU that answers as one on CUDA device 0."""

    is_cuda = True

    def get_device(self):
        return 0


def fake(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(FakeCuda)


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the C call and the stream getter; returns the recorded calls."""
    calls = []
    monkeypatch.setattr(kernels, "_call", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(kernels, "_stream", lambda index: 7000 + index)
    kernels.reset_launches()
    return calls


def _work(rows):
    return tell.WorkList(beg=fake(rows, dtype=I32), len=fake(rows, dtype=I32),
                         dst=fake(rows, dtype=I32), split_rows=fake(0, dtype=I32),
                         split_ptr=fake(1, dtype=I32), n_partials=0, n_nonempty=rows)


def _valid():
    """{launcher: (function, {argument name: value})} with valid operands."""
    s, l = 64, 128
    w = _work(60)
    return {
        "bsr_tile": (kernels.bsr_tile, dict(
            tiles=fake(3, 64, 64, dtype=torch.bfloat16), ptr=fake(3, dtype=I32),
            order=fake(3, dtype=I32), hblk=fake(3, dtype=I32), h=fake(120, 16), n=120,
            t_blocks=2, transpose=False, row_order=fake(2, dtype=I32))),
        "csr_spmm": (kernels.csr_spmm, dict(work=w, cols=fake(9, dtype=I32), coef=fake(9),
                                            h=fake(60, 16), n=60, out=fake(60, 16))),
        "ell_spmm": (kernels.ell_spmm, dict(
            work_beg=w.beg, work_len=w.len, work_dst=w.dst, split_rows=w.split_rows,
            split_ptr=w.split_ptr, cols=fake(9, dtype=I32), coef=fake(9), h=fake(60, 16),
            n=60, n_partials=0)),
        "gather_probe": (kernels.gather_probe, dict(idx=fake(4096, dtype=I32), h=fake(s, l))),
        "scatter_probe": (kernels.scatter_probe, dict(idx=fake(4096, dtype=I32),
                                                      coef=fake(4096), h=fake(s, l), mb=1000)),
        "taa_rows": (kernels.taa_rows, dict(idx=fake(s, 4, dtype=I32), strides=(4, 0, 1),
                                            tab=fake(s, l), steps=4, reps=2)),
        "taa_lanes": (kernels.taa_lanes, dict(idx=fake(3, l, dtype=I32), strides=(0, 1, l),
                                              tab=fake(s, l, dtype=torch.bfloat16), steps=3)),
        "cumsum_cols": (kernels.cumsum_cols, dict(tab=fake(s, l), reps=2)),
        "piece": (kernels.piece, dict(ids=fake(s, 1, dtype=I32), coef=fake(s, 1),
                                      begin=fake(s, 1, dtype=I32), end=fake(s, 1, dtype=I32),
                                      tab=fake(s, l), reps=2)),
    }


# per launcher: the operand that a fault is put into. Device: one beside the
# main operand (cumsum_cols has only the one); dtype and contiguity: any.
_DEVICE = {"bsr_tile": "ptr", "csr_spmm": "coef", "ell_spmm": "coef", "gather_probe": "idx",
           "scatter_probe": "coef", "taa_rows": "idx", "taa_lanes": "idx",
           "cumsum_cols": "tab", "piece": "coef"}
_DTYPE = {"bsr_tile": "h", "csr_spmm": "cols", "ell_spmm": "work_dst", "gather_probe": "h",
          "scatter_probe": "idx", "taa_rows": "tab", "taa_lanes": "idx", "cumsum_cols": "tab",
          "piece": "end"}
_STRIDED = {"bsr_tile": "tiles", "csr_spmm": "out", "ell_spmm": "coef", "gather_probe": "h",
            "scatter_probe": "h", "taa_rows": "tab", "taa_lanes": "tab", "cumsum_cols": "tab",
            "piece": "tab"}


def _shape_fault(name):
    s, l = 64, 128
    return {"bsr_tile": dict(h=fake(121, 16)),                  # not n rows
            "csr_spmm": dict(out=fake(61, 16)),                 # not [n, d]
            "ell_spmm": dict(work_len=fake(61, dtype=I32)),     # not one per item
            "gather_probe": dict(h=fake(5)),                    # no table
            "scatter_probe": dict(mb=5000),                     # more than the ids
            "taa_rows": dict(strides=(5, 0, 1)),                # runs past the indices
            "taa_lanes": dict(steps=4),                         # a step more than idx holds
            "cumsum_cols": dict(tab=fake(5)),
            "piece": dict(begin=fake(s + 1, 1, dtype=I32))}[name]


@pytest.mark.parametrize("name", list(kernels.launches))
def test_a_valid_call_reaches_the_c_function_once(recorder, name):
    fn, args = _valid()[name]
    out = fn(**args)
    assert [c[0] for c in recorder] == [name]
    call = recorder[0][1]
    assert call[-1] == 7000  # the current stream of device 0, read at the call
    assert out.dtype == torch.float32 and out.data_ptr() in call
    if name in ("csr_spmm", "ell_spmm"):  # d = 16 and torch's aligned bases: 16-byte loads
        assert call[12:14] == (16, 4)
    if name == "taa_rows":
        assert call[-2] == kernels.TAA_FORMS.index("row") and call[1:4] == (4, 0, 1)


@pytest.mark.parametrize("fault", ["device", "dtype", "contiguity", "shape"])
@pytest.mark.parametrize("name", list(kernels.launches))
def test_launchers_refuse_a_wrong_operand(recorder, name, fault):
    """The checks of device, type, contiguity and shape stand before the C
    call: a refused call launches nothing and counts nothing."""
    fn, args = _valid()[name]
    error = ValueError
    if fault == "device":      # an operand that lies on the CPU beside CUDA ones
        t = args[_DEVICE[name]]
        args[_DEVICE[name]] = torch.zeros(t.shape, dtype=t.dtype)
        if name == "cumsum_cols":
            error = RuntimeError
    elif fault == "dtype":
        t = args[_DTYPE[name]]
        args[_DTYPE[name]] = torch.zeros(t.shape, dtype=torch.float64).as_subclass(FakeCuda)
        error = TypeError
    elif fault == "contiguity":
        t = args[_STRIDED[name]]
        wide = fake(*t.shape[:-1], 2 * t.shape[-1], dtype=t.dtype)
        args[_STRIDED[name]] = wide[..., ::2]
        assert args[_STRIDED[name]].shape == t.shape
        assert not args[_STRIDED[name]].is_contiguous()
    else:
        args.update(_shape_fault(name))
    with pytest.raises(error):
        fn(**args)
    assert recorder == [] and all(v == 0 for v in kernels.launches.values())


def test_h_is_made_contiguous_for_the_graph_kernels(recorder):
    """Kernels 2 and 3 take a strided h (a column slice of the pair tensor)."""
    _, args = _valid()["ell_spmm"]
    args["h"] = fake(60, 32)[:, :16]
    kernels.ell_spmm(**args)
    assert len(recorder) == 1 and recorder[0][1][12] == 16


@pytest.mark.parametrize("h_rows", [7, 300])
@pytest.mark.parametrize("accumulate", [False, True])
def test_csr_spmm_takes_h_of_another_row_count(recorder, h_rows, accumulate):
    """A rectangular operator (the sharded trainer's boundary and its
    transpose): the CSR has n = 60 rows, h has 7 (the halo rows) or 300. The
    output has n rows, and h reaches the C call as it is."""
    fn, args = _valid()["csr_spmm"]
    args["h"] = fake(h_rows, 16)
    if not accumulate:
        args["out"] = None
    out = fn(**args)
    assert [c[0] for c in recorder] == ["csr_spmm"]
    call = recorder[0][1]
    assert tuple(out.shape) == (60, 16)
    assert call[9] == args["h"].data_ptr() and call[10] == out.data_ptr()
    assert call[12:15] == (16, 4, int(accumulate))


def test_the_real_call_counts_a_launch_in_one_place(monkeypatch):
    """``_call`` binds the C function once and counts where it launches."""
    seen = []

    def c_fn(*args):
        seen.append(args)
        return 0 if len(seen) < 3 else 700

    monkeypatch.setitem(kernels._fns, "cumsum_cols", c_fn)
    monkeypatch.setattr(kernels, "_stream", lambda index: 0)
    monkeypatch.setattr(kernels, "_lib", lambda source: pytest.fail("rebound a bound kernel"))
    kernels.reset_launches()
    for _ in range(2):
        kernels.cumsum_cols(fake(64, 128))
    assert kernels.launches["cumsum_cols"] == 2 and sum(kernels.launches.values()) == 2
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernels.cumsum_cols(fake(64, 128))
    assert kernels.launches["cumsum_cols"] == 2
    kernels.reset_launches()


def test_probe_cases_work_their_layout_out_once(monkeypatch):
    case = dg.bisect_cases("cpu", 128, 128, 8, 256)[2]
    assert (case.axis, case.strides, case.steps) == (0, (dg.BISECT_STEPS, 0, 1),
                                                     dg.BISECT_STEPS)
    monkeypatch.setattr(dg, "_layout", lambda *a: pytest.fail("laid out again"))
    np.testing.assert_array_equal(case.run().numpy(), case.plain().numpy())


@pytest.mark.parametrize("d,bases,vec", [
    (16, (0, 0, 0), 8), (32, (0, 0, 0), 8), (24, (0, 0, 0), 8), (12, (0, 0, 0), 4),
    (82, (0, 0, 0), 2), (41, (0, 0, 0), 1),
    (16, (0, 8, 0), 4),     # out is 8-byte aligned only
    (16, (0, 4, 0), 2),     # out is 4-byte aligned only
    (16, (0, 0, 8), 2),     # the f32 partials are 8-byte aligned only
    (16, (2, 0, 0), 1)])    # h is 2-byte aligned only
def test_spmm_load_width_of_bf16_rows_in_bytes(d, bases, vec):
    """bf16 rows: 16-byte loads are 8 features; a row of 164 bytes (d = 82)
    takes 4-byte loads and one of 82 bytes (d = 41) 2-byte loads; the f32
    partials are aligned to the f32 store of the same features."""
    assert kernels.spmm_vec(d, *bases, itemsize=2) == vec


def _as(args, dtype, *names):
    for name in names:
        args[name] = args[name].to(dtype).as_subclass(FakeCuda)
    return args


@pytest.mark.parametrize("name", ["bsr_tile", "csr_spmm", "ell_spmm"])
def test_bf16_activations_reach_the_bf16_variant(recorder, name):
    """bf16 h (and out, and the coefficients of kernels 2 and 3) reach the C
    entry with the bf16 code and, for kernels 2 and 3, 16-byte loads of 8
    features; the output is bf16."""
    fn, args = _valid()[name]
    args = _as(args, torch.bfloat16, *{"bsr_tile": ("h",), "csr_spmm": ("h", "coef", "out"),
                                       "ell_spmm": ("h", "coef")}[name])
    out = fn(**args)
    assert [c[0] for c in recorder] == [name] and out.dtype == torch.bfloat16
    call = recorder[0][1]
    if name == "bsr_tile":
        assert call[-2] == kernels.dtype_code(torch.bfloat16) == 1
    else:
        assert call[12:14] == (16, 8) and call[-2] == kernels.spmm_code(torch.bfloat16,
                                                                         torch.bfloat16) == 3


@pytest.mark.parametrize("name", ["csr_spmm", "ell_spmm"])
def test_f32_rows_with_bf16_coefficients_have_their_own_variant(recorder, name):
    fn, args = _valid()[name]
    out = fn(**_as(args, torch.bfloat16, "coef"))
    assert out.dtype == torch.float32
    assert recorder[0][1][12:14] == (16, 4) and recorder[0][1][-2] == 1


def test_f32_calls_carry_the_f32_code(recorder):
    for name in ("bsr_tile", "csr_spmm", "ell_spmm"):
        fn, args = _valid()[name]
        fn(**args)
    assert [c[1][-2] for c in recorder] == [0, 0, 0]


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in ("bsr_tile", "csr_spmm", "ell_spmm")
    for dtype in (torch.float16, torch.float64)
] + [("csr_spmm", "bf16 h with f32 coef"), ("ell_spmm", "bf16 h with f32 coef")])
def test_a_type_without_a_variant_is_refused(recorder, name, dtype):
    """No cast to reach another variant and no plain fallback: f16 or f64
    activations, and bf16 rows with f32 coefficients, raise before the C call."""
    fn, args = _valid()[name]
    if dtype == "bf16 h with f32 coef":
        args = _as(args, torch.bfloat16, "h", *(("out",) if name == "csr_spmm" else ()))
    else:
        args = _as(args, dtype, "h")
    with pytest.raises(TypeError):
        fn(**args)
    assert recorder == [] and all(v == 0 for v in kernels.launches.values())


def test_kernel_1_planes_follow_the_type_of_h():
    """f32 h is read as three bf16 planes, bf16 h as one; the tile rules of
    the tensor-core kernel are the same for both, and other types are refused."""
    assert kernels.BSR_PLANES == {torch.float32: 3, torch.bfloat16: 1}
    for h_dtype in (torch.float32, torch.bfloat16):
        assert kernels.bsr_mma_width(torch.bfloat16, 256, 9, 41, h_dtype) == 48
        assert kernels.bsr_mma_width(torch.float32, 256, 9, 41, h_dtype) is None
    with pytest.raises(TypeError):
        kernels.bsr_mma_width(torch.bfloat16, 256, 9, 41, torch.float16)
