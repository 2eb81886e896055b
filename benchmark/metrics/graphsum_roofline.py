"""graphsum_roofline (%): the least time of the slice's adjacency passes
(benchmark/roofline.py) over the device time of the program's aggregation
kernels, found by name. With sparse features the layer-0 product and dW run
on kernels 2 and 3 as well, so their least time joins the count."""

from benchmark import roofline
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
    parts = ("aggregation", "layer0") if ctx.shapes.feature_matmul == "sparse" else ("aggregation",)
    least = 0.0
    for e in ctx.job_epochs:
        work = roofline.job(ctx.shapes, e, ctx.early_stopping)
        least += sum(work[p].least_s(ctx.shapes.dtype) for p in parts)
    return 100.0 * least / device_s
