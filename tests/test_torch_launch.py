"""The launch path of the port's kernels, as far as the CPU can follow it.

What the launchers decide in Python is tested as plain functions: the load
width of kernels 2 and 3 from the feature width and the bases' alignment, the
forms of ``taa_rows`` and ``taa_lanes`` from the strides, for every layout the
probes use, and where probe A counts.
The launchers themselves are driven with tensors that claim to lie on a card
(``FakeCuda``, a Tensor subclass whose storage is on the CPU) and with the C
call replaced by a recorder: a valid call reaches the C function once, with
the arguments the kernel expects, and a wrong device, type, shape or a
non-contiguous operand is refused before it.
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
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
    cases go to ``taa_lanes``, whose group form takes a compact index [steps,
    L] and whose general form a full one."""
    case = _probe_cases()[i]
    s, l = case.tab.shape
    if case.axis == 1:
        assert case.form in ("full_lanes", "compact_lanes")
        form = kernels.taa_lanes_form(case.strides, s, l, case.steps, case.tab.element_size())
        assert form.form == ("group" if case.form == "compact_lanes" else "general")
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


# every axis-1 layout of the 20 at the scripts' full size: (label, S, L,
# itemsize, steps, strides); the compact ones with the group form's (R, tile)
_LANE_LAYOUTS = [
    *((f"lane_kernel [{s}x{l}] {dt} x{steps}", s, l, 2 if dt == "bfloat16" else 4, steps,
       (0, 1, l)) for s, l, dt, steps in dg.LANE_SHAPES),
    ("k4 [16x8192]", 16, 8192, 4, 1, (8192, 1, 0)),
    *((f"envelope axis 1 [{s}x{l}]", s, l, 4, 1, (l, 1, 0))
      for s, l, axis in dg.ENVELOPE_SHAPES if axis == 1)]
_GROUPS = {"lane_kernel [16x8192] bfloat16 x64": (4, 256),
           "lane_kernel [16x32768] bfloat16 x16": (2, 2048),
           "lane_kernel [128x8192] float32 x64": (4, 2048)}


@pytest.mark.parametrize("label,s,l,itemsize,steps,strides", _LANE_LAYOUTS,
                         ids=[c[0] for c in _LANE_LAYOUTS])
def test_taa_lanes_form_of_every_axis_1_layout(label, s, l, itemsize, steps, strides):
    """The three compact shapes of lane_kernel take the group form: R rows of
    4 to 16 bytes a column whose staged [L][R] fits a block's 232,448 bytes of
    shared memory, and column tiles of whole warps that, with the groups, fill
    the 132 SMs about once (at [16, 8192] bf16 R = 4, whose stages and index
    loads move 16.8 MB where R = 8 moves 21). k4 and the envelope's full
    indices take the general form."""
    assert len(_LANE_LAYOUTS) == 6
    form = kernels.taa_lanes_form(strides, s, l, steps, itemsize)
    if label not in _GROUPS:
        assert form == ("general", 1, kernels.TAA_LANE_TILE)
        return
    assert form.form == "group" and (form.rows, form.tile) == _GROUPS[label]
    assert form.rows * l * itemsize <= kernels.SMEM_BLOCK_BYTES == 232448
    assert form.rows * itemsize in (4, 8, 16) and form.tile % 32 == 0
    ctas = -(-s // form.rows) * -(-l // form.tile)
    assert kernels.H100_SMS * 3 // 4 <= ctas <= kernels.H100_SMS


@pytest.mark.parametrize("strides,s,l,steps,itemsize,form", [
    ((0, 1, 128), 3, 128, 2, 2, ("group", 4, 32)),        # 3 rows: one group, a padded row
    ((0, 1, 128), 1, 128, 5, 4, ("group", 1, 32)),        # one f32 row: 4 bytes a column
    ((0, 1, 128), 1, 128, 5, 2, ("group", 2, 32)),        # one bf16 row staged as 2
    ((0, 0, 1), 64, 128, 3, 4, ("group", 4, 32)),         # one index for every column
    ((0, 1, 58000), 4, 58000, 2, 4, ("group", 1, 1760)),  # 232,000 B: one f32 row fits
    ((0, 1, 58000), 4, 58000, 2, 2, ("group", 2, 896)),   # 2 bf16 rows, 232,000 B
    ((0, 1, 60000), 4, 60000, 2, 4, ("general", 1, 1024)),  # 240,000 B a f32 row
    ((0, 1, 70000), 2, 70000, 1, 4, ("general", 1, 1024)),  # a row above shared memory
    ((0, 1, 2**24), 2, 2**24, 129, 4, ("general", 1, 1024)),  # offsets past 2^31
    ((128, 1, 0), 8, 128, 1, 4, ("general", 1, 1024)),   # a full index
    ((0, 1, 16384), 8, 16384, 64, 2, ("group", 4, 256)),  # 8 rows exceed the block
    ((0, 1, 4096), 4, 4096, 64, 4, ("group", 2, 64)),     # 2 groups of 2 move less than 1 of 4
    ((0, 1, 128), 16, 128, 64, 2, ("group", 8, 32)),
])
def test_taa_lanes_form_from_strides_and_sizes(strides, s, l, steps, itemsize, form):
    got = kernels.taa_lanes_form(strides, s, l, steps, itemsize)
    assert tuple(got) == form
    assert kernels.TAA_LANES_FORMS == ("general", "group")


def lanes_group_restated(idx, strides, tab, steps, reps, rows, tile):
    """The group form's work in plain torch, CTA by CTA: each group of ``rows``
    table rows staged as [L][rows] f32 (rows past S are zeros), each tile of
    columns summed step after step, rep after rep, from zero."""
    s, l = tab.shape
    _, sj, sk = strides
    flat = idx.reshape(-1).long()
    out = torch.full((s, l), float("nan"))
    for g0 in range(0, s, rows):
        n = min(rows, s - g0)
        stage = torch.zeros(l, rows)
        stage[:, :n] = tab[g0:g0 + n].float().T
        for j0 in range(0, l, tile):
            j = torch.arange(j0, min(l, j0 + tile))
            acc = torch.zeros(len(j), rows)
            for _ in range(reps):
                for k in range(steps):
                    acc = acc + stage[flat[j * sj + k * sk]]
            out[g0:g0 + n, j0:j0 + len(j)] = acc.T[:n]
    return out


@pytest.mark.parametrize("which", ["lane_kernel 0", "lane_kernel 1", "lane_kernel 2",
                                   "3 bf16 rows", "5 f32 rows, 2 reps", "one index a step"])
def test_group_form_covers_every_element_in_the_plain_order(which):
    """The three compact cases (L cut by 64), ragged groups and repeats: the
    group form's CTAs, at the rows and tile that ``taa_lanes_form`` picks,
    write every element once, equal bit for bit to the plain version."""
    if which.startswith("lane_kernel"):
        case = [c for c in dg.forms_cases("cpu", scale=64) if c.axis == 1][int(which[-1])]
        idx, strides, tab, steps, reps = case.idx, case.strides, case.tab, case.steps, 1
    else:
        rng = np.random.default_rng(len(which))
        s, dtype, reps = {"3 bf16 rows": (3, torch.bfloat16, 1),
                          "5 f32 rows, 2 reps": (5, torch.float32, 2),
                          "one index a step": (6, torch.float32, 1)}[which]
        l, steps = 200, 7
        tab = torch.from_numpy(rng.standard_normal((s, l)).astype(np.float32)).to(dtype)
        strides = (0, 0, 1) if which == "one index a step" else (0, 1, l)
        idx = torch.from_numpy(rng.integers(0, l, steps * l, dtype=np.int32))
    s, l = tab.shape
    form = kernels.taa_lanes_form(strides, s, l, steps, tab.element_size())
    assert form.form == "group"
    got = lanes_group_restated(idx, strides, tab, steps, reps, form.rows, form.tile)
    assert torch.equal(got, taa.taa_lanes_plain(idx, strides, tab, steps, reps))


@pytest.mark.parametrize("s,l,dtype,steps,reps,aligned", chip_smoke.LANE_EDGES)
def test_chip_smoke_edge_cases_take_the_group_form(s, l, dtype, steps, reps, aligned):
    """The cases that chip_smoke (j) adds off the scripts' shapes (ragged row
    groups, rows staged one value at a time) reach the group form, whose work
    restated CTA by CTA equals the plain version bit for bit."""
    rng = np.random.default_rng(s * l)
    tab = torch.from_numpy(rng.standard_normal((s, l), dtype=np.float32)).to(getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(0, l, steps * l, dtype=np.int32))
    strides = (0, 1, l)
    form = kernels.taa_lanes_form(strides, s, l, steps, tab.element_size())
    assert form.form == "group"
    assert s % form.rows or l % (16 // tab.element_size()) or not aligned  # a ragged path
    got = lanes_group_restated(idx, strides, tab, steps, reps, form.rows, form.tile)
    assert torch.equal(got, taa.taa_lanes_plain(idx, strides, tab, steps, reps))


@pytest.mark.parametrize("rows,path", [(16384, "shared"), (58112, "shared"),
                                       (58113, "global"), (1 << 17, "global")])
def test_gather_probe_path_from_the_table_rows(rows, path):
    """Probe A counts in shared memory while a table's int32 counts fit a
    block's 232,448 bytes, else in device memory."""
    assert kernels.gather_probe_path(rows) == path
    assert kernels.GATHER_PATHS == ("shared", "global")


@pytest.mark.parametrize("m,rows,path,blocks", [
    (1 << 20, 16384, "shared", 64),    # the histograms hold as many ints as idx
    (1 << 20, 1 << 17, "global", 128),  # at least 8192 ids a CTA
    (1 << 24, 1024, "shared", 264),    # at most two CTAs an SM
    (4096, 16384, "shared", 1), (100, 1 << 17, "global", 1)])
def test_gather_count_blocks(m, rows, path, blocks):
    assert kernels.gather_count_blocks(m, rows, path) == blocks


@pytest.mark.parametrize("rows,path", [(16384, "shared"), (1 << 17, "global")])
def test_gather_probe_passes_its_scratch_and_path(recorder, monkeypatch, rows, path):
    """One wrapper call is one C call: with the ids and the table it passes
    the count scratch (a histogram a count CTA on the shared path, one cleared
    count array on the global path, then an int for the ticket and a stray-id
    flag a count CTA), the contraction's partial rows, the output, and the
    path's number."""
    m, d = 1 << 20, 8
    idx, h = fake(m, dtype=I32), fake(rows, d)
    made = {}

    def spy(real):
        def make(*args, **kwargs):
            t = real(*args, **kwargs)
            made[t.data_ptr()] = (real.__name__, tuple(t.shape), t.dtype)
            return t
        return make

    monkeypatch.setattr(torch, "empty", spy(torch.empty))
    monkeypatch.setattr(torch, "zeros", spy(torch.zeros))
    out = kernels.gather_probe(idx, h)
    assert [c[0] for c in recorder] == ["gather_probe"]
    call = recorder[0][1]
    blocks = kernels.gather_count_blocks(m, rows, path)
    assert call[:2] == (idx.data_ptr(), h.data_ptr()) and call[4] == out.data_ptr()
    assert call[5:11] == (m, rows, d, blocks, kernels.GATHER_PATHS.index(path), 7000)
    # the count arrays, then the ticket and the count CTAs' flags
    counts = (("empty", (blocks * rows + 1 + blocks,), I32) if path == "shared"
              else ("zeros", (rows + 1 + blocks,), I32))
    assert made[call[2]] == counts
    assert made[call[3]] == ("empty", (128, d), torch.float32)  # a partial row a CTA
    assert tuple(out.shape) == (1, d) and out.dtype == torch.float32


@pytest.mark.parametrize("rows,mb,d", [
    (16384, 1 << 16, 128), (16384, 1 << 16, 41), (64, 1000, 8), (300, 0, 8), (1, 1, 3),
    (1 << 20, 1 << 16, 16)])
def test_scatter_probe_passes_a_flag_a_cta(recorder, monkeypatch, rows, mb, d):
    """One wrapper call is one C call: with the ids, coefficients and table it
    passes the output, its scratch (an int32 fault flag for each of the
    SCATTER_CTAS CTAs, which each writes before any reads, right past out's
    end in the one allocation), the shape and the number of CTAs; nothing is
    cleared."""
    idx, coef, h = fake(max(mb, 1), dtype=I32), fake(max(mb, 1)), fake(rows, d)
    made = {}

    def spy(real):
        def make(*args, **kwargs):
            t = real(*args, **kwargs)
            made[t.data_ptr()] = (real.__name__, tuple(t.shape), t.dtype)
            return t
        return make

    monkeypatch.setattr(torch, "empty", spy(torch.empty))
    monkeypatch.setattr(torch, "zeros", spy(torch.zeros))
    out = kernels.scatter_probe(idx, coef, h, mb)
    assert [c[0] for c in recorder] == ["scatter_probe"]
    call = recorder[0][1]
    assert call[:4] == (idx.data_ptr(), coef.data_ptr(), h.data_ptr(), out.data_ptr())
    assert made == {out.data_ptr(): ("empty", (rows * d + kernels.SCATTER_CTAS,), torch.float32)}
    assert call[4] == out.data_ptr() + 4 * rows * d and out.is_contiguous()
    assert out.untyped_storage().nbytes() == 4 * (rows * d + kernels.SCATTER_CTAS)
    assert call[5:] == (rows, mb, d, kernels.SCATTER_CTAS, 7000)
    assert tuple(out.shape) == (rows, d) and out.dtype == torch.float32


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


def _plan(w):
    """An ELL plan's work list of 60 rows over 9 slots, as the attention
    launchers read it."""
    return types.SimpleNamespace(work_beg=w.beg, work_len=w.len, work_dst=w.dst,
                                 split_rows=w.split_rows, split_ptr=w.split_ptr,
                                 cols=fake(9, dtype=I32), n_nodes=60, n_partials=0)


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
        "layer0_pair": (kernels.layer0_pair, dict(x=fake(60, 12), w=fake(12, 16),
                                                  seeds=fake(2, dtype=torch.int64), rate=0.5,
                                                  with_eval=True)),
        "gat_forward": (kernels.gat_forward, dict(
            plan=_plan(w), partial_rows=fake(0, dtype=I32), z=fake(60, 16), sl=fake(60, 2),
            sr=fake(60, 2), heads=2, slope=0.2, rate=0.6, seeds=fake(2, dtype=torch.int64))),
        "gat_rows": (kernels.gat_rows, dict(
            plan=_plan(w), partial_rows=fake(0, dtype=I32), g=fake(60, 16), z=fake(60, 16),
            sl=fake(60, 2), sr=fake(60, 2), stats=fake(60, 2, 2), heads=2, slope=0.2, rate=0.6,
            seeds=fake(2, dtype=torch.int64))),
        "gat_cols": (kernels.gat_cols, dict(
            plan_t=_plan(w), partial_rows_t=fake(0, dtype=I32), rev=fake(9, dtype=I32),
            g=fake(60, 16), z=fake(60, 16), sr=fake(60, 2), node=fake(60, 2, 4), heads=2,
            slope=0.2, rate=0.6, seeds=fake(2, dtype=torch.int64))),
        "ell_blend": (kernels.ell_blend, dict(
            work_beg=w.beg, work_len=w.len, work_dst=w.dst, split_rows=w.split_rows,
            split_ptr=w.split_ptr, cols=fake(9, dtype=I32), coef=fake(9), h=fake(60, 16),
            h0=fake(60, 16), n=60, n_partials=0, a=0.9, b=0.1)),
        "gcnii_epilogue": (kernels.gcnii_epilogue, dict(
            st=fake(60, 64), se=fake(60, 64), w=fake(64, 64), seeds=fake(2, dtype=torch.int64),
            theta=0.25, rate=0.6, concat=True)),
        "gcnii_epilogue_bwd": (kernels.gcnii_epilogue_bwd, dict(
            g=fake(60, 64), keep=fake(60, 64, dtype=torch.bool), relu=fake(60, 2, dtype=I32),
            w=fake(64, 64), theta=0.25, rate=0.6)),
    }


# per launcher: the operand that a fault is put into. Device: one beside the
# main operand (cumsum_cols has only the one); dtype and contiguity: any.
_DEVICE = {"bsr_tile": "ptr", "csr_spmm": "coef", "ell_spmm": "coef", "gather_probe": "idx",
           "scatter_probe": "coef", "taa_rows": "idx", "taa_lanes": "idx",
           "cumsum_cols": "tab", "piece": "coef", "layer0_pair": "w", "gat_forward": "sl",
           "gat_rows": "stats", "gat_cols": "node", "ell_blend": "h0", "gcnii_epilogue": "se",
           "gcnii_epilogue_bwd": "keep"}
_DTYPE = {"bsr_tile": "h", "csr_spmm": "cols", "ell_spmm": "work_dst", "gather_probe": "h",
          "scatter_probe": "idx", "taa_rows": "tab", "taa_lanes": "idx", "cumsum_cols": "tab",
          "piece": "end", "layer0_pair": "seeds", "gat_forward": "sr", "gat_rows": "g",
          "gat_cols": "rev", "ell_blend": "coef", "gcnii_epilogue": "seeds",
          "gcnii_epilogue_bwd": "relu"}
_STRIDED = {"bsr_tile": "tiles", "csr_spmm": "out", "ell_spmm": "coef", "gather_probe": "h",
            "scatter_probe": "h", "taa_rows": "tab", "taa_lanes": "tab", "cumsum_cols": "tab",
            "piece": "tab", "layer0_pair": "x", "gat_forward": "z", "gat_rows": "g",
            "gat_cols": "z", "ell_blend": "h0", "gcnii_epilogue": "st",
            "gcnii_epilogue_bwd": "g"}


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
            "piece": dict(begin=fake(s + 1, 1, dtype=I32)),
            "layer0_pair": dict(w=fake(13, 16)),                # not [F, H]
            "gat_forward": dict(sl=fake(61, 2)),                # not [n, K]
            "gat_rows": dict(stats=fake(60, 2)),                # not [n, K, 2]
            "gat_cols": dict(rev=fake(8, dtype=I32)),           # not a slot each
            "ell_blend": dict(h0=fake(61, 16)),                 # not [n, d]
            "gcnii_epilogue": dict(w=fake(64, 32)),             # not [H, H]
            "gcnii_epilogue_bwd": dict(relu=fake(60, 3, dtype=I32))}[name]  # not [n, H/32]


@pytest.mark.parametrize("name", list(kernels.launches))
def test_a_valid_call_reaches_the_c_function_once(recorder, name):
    fn, args = _valid()[name]
    out = fn(**args)
    assert [c[0] for c in recorder] == [name]
    call = recorder[0][1]
    assert call[-1] == 7000  # the current stream of device 0, read at the call
    for o in out if isinstance(out, tuple) else (out,):  # layer0_pair: (xd, zt, ze)
        assert o.data_ptr() in call
        # gcnii_epilogue: (ht, he) f32, then its mask (bool) and ReLU's bits (int32)
        assert o.dtype == torch.float32 or name == "gcnii_epilogue"
    if name in ("csr_spmm", "ell_spmm", "ell_blend"):  # d = 16, aligned bases: 16-byte loads
        assert call[12:14] == (16, 4)
    if name == "ell_blend":  # one half: h0 as both halves' base, out as the upper half's
        h0 = args["h0"].data_ptr()
        assert call[14:] == (h0, h0, out.data_ptr(), 16, 0.9, 0.1, 7000)
    if name == "gcnii_epilogue":  # the halves side by side in one [60, 128] buffer; dropout
        # 0.6: a kept value times 2.5, kept below q·2^32; θ and 1 − θ
        ht, he, keep, relu = out
        assert ht.dtype == he.dtype == torch.float32
        assert keep.dtype == torch.bool and relu.dtype == torch.int32
        assert tuple(keep.shape) == (60, 64) and tuple(relu.shape) == (60, 2)
        assert he.data_ptr() == ht.data_ptr() + 4 * 64
        assert call == (args["st"].data_ptr(), args["se"].data_ptr(), args["w"].data_ptr(),
                        args["seeds"].data_ptr(), ht.data_ptr(), he.data_ptr(), 128,
                        keep.data_ptr(), relu.data_ptr(), 60, 64, 0.25, 0.75, 2.5, 1717986944,
                        7000)
    if name == "gcnii_epilogue_bwd":  # (gs, gz) after g, keep, relu and W
        gs, gz = out
        assert call == (args["g"].data_ptr(), args["keep"].data_ptr(), args["relu"].data_ptr(),
                        args["w"].data_ptr(), gz.data_ptr(), gs.data_ptr(), 60, 64, 0.25, 0.75,
                        2.5, 7000)
    if name == "taa_rows":
        assert call[-2] == kernels.TAA_FORMS.index("row") and call[1:4] == (4, 0, 1)
    if name == "taa_lanes":  # a compact bf16 index: 8 rows a group, tiles of 32 columns
        assert call[-4:-1] == (kernels.TAA_LANES_FORMS.index("group"), 8, 32)
    if name == "cumsum_cols":  # out, then the scan's totals in an allocation of their own
        assert call[:2] == (args["tab"].data_ptr(), out.data_ptr()) and call[2] != out.data_ptr()
        assert call[3:6] == (64, 128, 2)
    if name == "layer0_pair":  # 16 columns in one flat launch; dropout 0.5: xd = 2x where kept,
        # 8 bits of a uniform an element, kept below 128
        assert call[6:] == (60, 12, 16, 0, 16, 1, 0.5, 2.0, 1, 128, 8, 1, 0, 7000)
    if name.startswith("gat_"):  # 2 heads of 8 features: 4-float loads, a lane a head, 2 a
        # slot, 2 steps; dropout 0.6: a kept weight times 2.5, kept below q·2^32; the launch
        # counted under its split
        assert call[-10:-1] == (2, 8, 4, 1, 2, 2, 0.2, 2.5, 1717986944)
        assert kernels.gat_layouts == {(name, 4, 1, 2): 1}
    if name == "piece":  # the [S+1, L] scan and its totals, each in an allocation of its own
        assert call[4:6] == (args["tab"].data_ptr(), out.data_ptr()) and call[8:11] == (64, 128, 2)
        assert call[6] != call[7] and out.data_ptr() not in call[6:8]


@pytest.mark.parametrize("s,l", [(1, 1), (63, 5), (65, 127), (129, 128), (300, 333)])
@pytest.mark.parametrize("name", ["cumsum_cols", "piece"])
def test_scan_scratch_follows_the_tiles(recorder, monkeypatch, name, s, l):
    """The scratch holds (chunks + 2) rows of 128 totals a column tile (chunks
    of 128 rows, tiles of 128 columns) and is the pointer the C call gets."""
    made, make = [], kernels._scan_totals
    monkeypatch.setattr(kernels, "_scan_totals", lambda *a: made.append(make(*a)) or made[-1])
    if name == "cumsum_cols":
        out = kernels.cumsum_cols(fake(s, l), 3)
        totals = recorder[0][1][2]
    else:
        out = kernels.piece(fake(s, 1, dtype=I32), fake(s, 1), fake(s, 1, dtype=I32),
                            fake(s, 1, dtype=I32), fake(s, l), 3)
        totals = recorder[0][1][7]
    (scratch,) = made
    assert scratch.shape == ((-(-s // 128) + 2) * -(-l // 128), 128)
    assert scratch.dtype == torch.float32 and scratch.data_ptr() == totals
    assert out.shape == (s, l) and out.is_contiguous()
    assert recorder[0][1][-4:-1] == (s, l, 3)


@pytest.mark.parametrize("s,l,fits", [
    (65535 * 64, 128, True),                 # the cap the scans had before
    (2**31 - 2, 1, True), (2**31 - 1, 1, False),  # piece's S + 1 rows are an int
    (128 << 16, 128 * ((1 << 15) - 1), True), (128 << 16, 128 << 15, False)])  # 2^31 tiles
def test_scan_cap_is_the_kernels_ints(s, l, fits):
    """The scans refuse a shape whose rows or tiles the kernel's ints cannot
    hold, and still take the rows of the cap before them at 128 columns."""
    if fits:
        assert kernels._scan_totals(s, l, "meta").shape[1] == kernels.SCAN_TILE_COLS
    else:
        with pytest.raises(ValueError, match="column scans"):
            kernels._scan_totals(s, l, "meta")


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


def test_a_full_index_reaches_the_general_form_of_taa_lanes(recorder):
    _, args = _valid()["taa_lanes"]
    s, l = args["tab"].shape
    args.update(idx=fake(s, l, dtype=I32), strides=(l, 1, 0), steps=1)
    kernels.taa_lanes(**args)
    assert recorder[0][1][-4:-1] == (0, 1, kernels.TAA_LANE_TILE)


@pytest.mark.parametrize("name", ["gat_forward", "gat_rows", "gat_cols"])
@pytest.mark.parametrize("ld,split", [(44, (4, 8, 8, 2)), (41, (1, 8, 8, 8)), (8, (4, 1, 1, 2))])
def test_gat_launch_splits_a_padded_head(recorder, name, ld, split):
    """One head in rows of LD floats: the C call gets LD and the split over it
    (1 x 41 padded to 44: 4-float loads, in the forward 8 lanes of 2 steps,
    in the backward passes 4 lanes of 4; unpadded, 8 scalar loads a lane),
    outputs at the stride LD, and the launch is counted under its split."""
    if name != "gat_forward" and ld == 44:
        split = (4, 4, 4, 4)
    fn, args = _valid()[name]
    n = 60
    args.update(heads=1, z=fake(n, ld))
    for what, shape in {"g": (n, ld), "sl": (n, 1), "sr": (n, 1), "stats": (n, 1, 2),
                        "node": (n, 1, 4)}.items():
        if what in args:
            args[what] = fake(*shape)
    out = fn(**args)
    assert recorder[0][1][-10:-4] == (1, ld, *split)
    assert kernels.gat_layouts == {(name, split[0], split[1], split[3]): 1}
    if name != "gat_rows":
        assert tuple(out[0].shape) == (n, ld)


@pytest.mark.parametrize("dh,h0,vec", [(16, True, 4), (6, True, 2), (16, False, 4),
                                       (5, True, 1)])
def test_ell_blend_pair_stores_each_half_apart(recorder, dh, h0, vec):
    """The fused pair's blended pass: h at the concatenated width 2·dh, each
    half's h0 and out in a tensor of its own; the load width is kernel 3's at
    2·dh narrowed to one that dh takes; without h0 both of its bases are null."""
    fn, args = _valid()["ell_blend"]
    args.update(h=fake(60, 2 * dh), halves=2,
                h0=(fake(60, dh), fake(60, dh)) if h0 else None)
    lo, hi = fn(**args)
    assert [c[0] for c in recorder] == ["ell_blend"]
    call = recorder[0][1]
    assert tuple(lo.shape) == tuple(hi.shape) == (60, dh) and lo.data_ptr() != hi.data_ptr()
    assert call[10] == lo.data_ptr() and call[16] == hi.data_ptr()
    assert call[12:14] == (2 * dh, vec) and call[17] == dh
    assert call[14:16] == ((args["h0"][0].data_ptr(), args["h0"][1].data_ptr()) if h0
                           else (None, None))
    with pytest.raises(ValueError):
        fn(**{**args, "h": fake(60, 2 * dh + 1)})  # no two equal halves
