"""aten_ms (ms): device milliseconds an epoch of every kernel that is not
one of the program's own (cuBLAS GEMMs, dropout's random draws, the loss,
Adam, copies of ATen), over the traced slice."""

from benchmark.trace import base_name

# every __global__ kernel of cuda_gcn_torch/csrc that the training path runs
PROGRAM_KERNELS = ("split_planes_kernel", "bsr_mma_kernel", "bsr_tile_kernel",
                   "csr_spmm_kernel", "ell_spmm_kernel", "reduce_partials_kernel")


def read(ctx):
    epochs = sum(ctx.job_epochs)
    if not ctx.records_ok or not epochs:
        return None
    return 1e3 * ctx.slice.kernel_s(lambda n: base_name(n) not in PROGRAM_KERNELS) / epochs
