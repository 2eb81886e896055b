// Kernel 2: gather SpMM over the rows of a CSR, walked as a work list.
//
//   out[i, f] = (accumulate ? out[i, f] : 0) + sum_{e in row i} coef[e] * h[cols[e], f]
//
// Replaces the residual aggregation of the JAX package, which is XLA rather
// than Pallas there: _segment_apply and, above 49,152 nodes, _blocked2d_apply
// over the flat bucketed piece layout (cuda_gcn_tpu/ops/graphsum.py:42,136).
// The piece layout worked around TPU gather and segment-sum costs; on the card
// the residual is plain CSR. The same kernel is the layer-0 product X * W of
// sparse features (ops/matmul.py), with W as the gathered operand.
//
// Bound on the H100: bytes. Each edge reads 8 bytes of index and value and one
// gathered row of h; the least traffic is every input read once and out
// written once, and the random row gathers sit far above that floor
// (spmm_common.cuh says what the design does about it; kernel 3 runs the same
// body). What is kernel 2's own:
//
// * The host cuts the rows into work items (ops/ell.py work_list): a row, or a
//   chunk of at most 256 edges of a longer row (the reddit residual has a row
//   of 37,181 edges at a mean of 19), longest first. One warp takes one item
//   and 8 warps make a CTA, so a CTA lasts as long as 8 similar items and no
//   warp scans for hubs. The chunks of a long row write partial sums that a
//   second kernel adds in chunk order.
// * The accumulate read of out is fused into the one store of each row. In
//   accumulate mode a row of no edges has nothing to add, so the host launches
//   only the items that have edges (they come first in the list); without
//   accumulate an empty row's item writes zeros.
//
// Every output row has one writer and a fixed summation order: no atomics,
// the same bits on every run (index_add_ on the card is not).

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_common.cuh"

namespace {

template <int G, int STEPS, int VEC, class T, class C>
__global__ void __launch_bounds__(spmm::kWarps * 32, spmm::kCtasPerSm)
csr_spmm_kernel(const int* __restrict__ work_beg, const int* __restrict__ work_len,
                const int* __restrict__ work_dst, const int* __restrict__ cols,
                const C* __restrict__ coef, const T* __restrict__ h, T* __restrict__ out,
                float* __restrict__ partial, int n_items, int d, int accumulate) {
  spmm::run_item<G, STEPS, VEC>(work_beg, work_len, work_dst, cols, coef, h, out, partial,
                                n_items, d, accumulate != 0);
}

}  // namespace

// `dtypes` is spmm::by_dtypes's code of h's (and out's) type and coef's;
// `vec` the features per load that kernels.spmm_vec chose.
extern "C" int csr_spmm(const void* work_beg, const void* work_len, const void* work_dst,
                        int n_items, const void* split_rows, const void* split_ptr,
                        int n_split, const void* cols, const void* coef, const void* h,
                        void* out, void* partial, int d, int vec, int accumulate, int dtypes,
                        void* stream) {
  const spmm::Args a = spmm::make_args(work_beg, work_len, work_dst, n_items, cols, coef, h,
                                       out, partial, d, accumulate, stream);
  return static_cast<int>(spmm::by_dtypes(dtypes, [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    using C = typename decltype(c)::type;
    return spmm::run<T>(a, vec, split_rows, split_ptr, n_split, [&](auto g, auto steps, auto v) {
      csr_spmm_kernel<decltype(g)::value, decltype(steps)::value, decltype(v)::value, T, C>
          <<<spmm::blocks_of(a), spmm::kWarps * 32, 0, a.stream>>>(
              a.beg, a.len, a.dst, a.cols, static_cast<const C*>(a.coef),
              static_cast<const T*>(a.h), static_cast<T*>(a.out), a.partial, a.n_items, a.d,
              a.accumulate);
    });
  }));
}
