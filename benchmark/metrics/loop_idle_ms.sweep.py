"""loop_idle_ms.sweep (ms): the device's idle time a traced job inside the
program's ``train.epochs`` spans and outside its ``graphs.eager`` and
``graphs.capture`` spans (cuda_gcn_torch/train.py, graphs.py): the replay
loop's gaps between graph launches, its chunk reads and the trailing
evaluation. Idle is the slice's time outside the union of its device
operations. None where the program records no ``train.epochs`` span, or the
slice holds no device operation or lost kernel records."""

LOOP = ("train.epochs",)
OUTSIDE = ("graphs.eager", "graphs.capture")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _minus(a, b):
    """The parts of the disjoint sorted intervals ``a`` outside those of ``b``."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
        if e > s:
            out.append((s, e))
    return out


def _spans(sl, names):
    """The union of the slice's host events named in ``names``."""
    return _union((s, e) for n, s, e, _ in sl.host if n in names)


def read(ctx):
    sl = ctx.slice
    if not ctx.records_ok or not ctx.job_epochs or not sl.device:
        return None
    loop = _spans(sl, LOOP)
    if not loop:
        return None
    idle = _minus(loop, _union(_spans(sl, OUTSIDE) + sl.busy_intervals()))
    return 1e-3 * sum(e - s for s, e in idle) / len(ctx.job_epochs)
