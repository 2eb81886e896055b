"""attention_roofline (%): the least time of the slice's attention passes
(the family's ``job_work`` part 'attention': each pass's columns, row
pointers, z and scores read once and its output written once) over the device
time of the attention kernels that ``attention_ms`` reads. None where the
slice holds none of them or the family gives no such part."""

from benchmark.registry import metric_reader


def read(ctx):
    ms = metric_reader("attention_ms")(ctx)
    if ms is None:
        return None
    least = ctx.least_s(("attention",))
    return None if least is None else 100.0 * least / (ms * 1e-3 * sum(ctx.job_epochs))
