"""epoch_mfu (%): the least time of the slice's work on the chip (the
family's ``job_work`` part 'total': every epoch, the trailing and the test
evaluations, the larger of bytes over HBM bandwidth and operations over the
type's peak) over the slice's length."""


def read(ctx):
    if ctx.slice.window_s <= 0 or not ctx.job_epochs:
        return None
    least = ctx.least_s(("total",))
    return None if least is None else 100.0 * least / ctx.slice.window_s
