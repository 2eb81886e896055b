"""propagation_roofline (%): the least time of the slice's propagation (the
family's ``job_work`` part 'propagation': each blended pass's columns,
coefficients, h and h0 read once and its output written once; each
transposed pass's columns, coefficients and g) over the device time of the
kernels that ``propagation_ms`` reads. None where the slice holds none of
them or the family gives no such part."""

from benchmark.registry import metric_reader


def read(ctx):
    ms = metric_reader("propagation_ms")(ctx)
    if ms is None:
        return None
    least = ctx.least_s(("propagation",))
    return None if least is None else 100.0 * least / (ms * 1e-3 * sum(ctx.job_epochs))
