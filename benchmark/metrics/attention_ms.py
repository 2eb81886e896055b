"""attention_ms (ms): device milliseconds an epoch of the GAT's attention
kernels (cuda_gcn_torch/csrc/gat_attention.cu: the forward, the backward's
row and column passes, each with its chunk reduction), found by name, over
the traced slice. None where the slice holds none of them."""

from benchmark.trace import base_name

KERNELS = ("gat_forward_kernel", "gat_forward_reduce_kernel", "gat_rows_kernel",
           "gat_rows_reduce_kernel", "gat_cols_kernel", "gat_cols_reduce_kernel")


def read(ctx):
    epochs = sum(ctx.job_epochs)
    if not ctx.records_ok or not epochs:
        return None
    s = ctx.slice.kernel_s(lambda n: base_name(n) in KERNELS)
    return 1e3 * s / epochs if s > 0 else None
