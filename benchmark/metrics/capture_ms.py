"""capture_ms (ms): the program's ``graphs.capture`` spans in the traced
slice (cuda_gcn_torch/graphs.py ``EpochGraph.capture``: the capture of the
epoch's CUDA graph and its instantiation, after the wait for the eager
epoch), summed and divided by the traced jobs. None where the program
records no such span."""

CAPTURE = "graphs.capture"


def read(ctx):
    spans = [e - s for n, s, e, _ in ctx.slice.host if n == CAPTURE]
    if not spans or not ctx.job_epochs:
        return None
    return 1e-3 * sum(spans) / len(ctx.job_epochs)
