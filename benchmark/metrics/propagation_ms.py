"""propagation_ms (ms): device milliseconds an epoch of kernel 3's launches
(cuda_gcn_torch/csrc/ell_spmm.cu: ``ell_spmm_kernel``, its blended form
``ell_blend_kernel``, and the chunked rows' ``reduce_partials_kernel`` of
spmm_common.cuh), found by name, over the traced slice. In GCNII's cell every
one of them is the propagation: the blended pair passes and the backward's
transposed passes. None where the slice holds none of them."""

from benchmark.trace import base_name

KERNELS = ("ell_spmm_kernel", "ell_blend_kernel", "reduce_partials_kernel")


def read(ctx):
    epochs = sum(ctx.job_epochs)
    if not ctx.records_ok or not epochs:
        return None
    s = ctx.slice.kernel_s(lambda n: base_name(n) in KERNELS)
    return 1e3 * s / epochs if s > 0 else None
