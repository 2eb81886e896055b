"""graphsum_roofline (%): the least time of the slice's adjacency passes (the
family's ``job_work`` part 'aggregation') over the device time of the
program's aggregation kernels, found by name. With sparse features the
layer-0 product and dW run on kernels 2 and 3 as well, so their least time
(the part 'layer0_spmm', which a family gives only then) joins the count."""

from benchmark.trace import base_name

# ops/graphsum.py -> bsr_tile.cu (with its split pre-pass), csr_spmm.cu,
# ell_spmm.cu (with the partials' reduction of spmm_common.cuh)
KERNELS = ("split_planes_kernel", "bsr_mma_kernel", "bsr_tile_kernel", "csr_spmm_kernel",
           "ell_spmm_kernel", "reduce_partials_kernel")


def read(ctx):
    if not ctx.records_ok or not ctx.job_epochs:
        return None
    device_s = ctx.slice.kernel_s(lambda n: base_name(n) in KERNELS)
    if device_s <= 0:
        return None
    least = ctx.least_s(("aggregation", "layer0_spmm"))
    return None if least is None else 100.0 * least / device_s
