"""epoch_mfu (%): the least time of the slice's work on the chip
(benchmark/roofline.py: every epoch, the trailing and the test evaluations,
the larger of bytes over HBM bandwidth and operations over the type's peak)
over the slice's length."""

from benchmark import roofline


def read(ctx):
    if ctx.slice.window_s <= 0 or not ctx.job_epochs:
        return None
    least = sum(roofline.job(ctx.shapes, e, ctx.early_stopping)["total"].least_s(ctx.shapes.dtype)
                for e in ctx.job_epochs)
    return 100.0 * least / ctx.slice.window_s
