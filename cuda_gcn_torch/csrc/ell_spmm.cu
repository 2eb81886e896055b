// Kernel 3: bucketed-ELL SpMM over a flat work list, every bucket in one launch.
//
//   out[rows_b[r], f] = sum_{k < W_b} coef_b[r, k] * h[cols_b[r, k], f]
//
// Replaces the TPU kernel _ell_kernel (cuda_gcn_tpu/ops/pallas_spmm.py:67),
// which pins h in VMEM and walks [TR, 64] index tiles of one bucket per
// pallas_call. On the card h is read from device memory and L2, and one launch
// covers every bucket: the host (ops/ell.py ell_plan) flattens the buckets into
// one slot array and lists work items, each a row's real slots, or a chunk of
// at most 256 slots of a wider row (synth-reddit has one of 43,403 edges). The
// pad slots are never read.
//
// Bound on the H100: bytes, and within that the row gathers of h, which L2 and
// device memory serve at a rate far below that of a stream (spmm_common.cuh
// says what the design does about it). The body is the one kernel 2 runs: one
// warp per item, the lanes split over (slot, feature) by d with the widest
// load that d and the bases allow, one gather in flight per slot group at 64
// warps an SM. An item of a whole row writes its output row once, in vector
// stores; the chunks of a wide row write partial sums, and a second kernel
// adds each row's partials in chunk order. Every output row has one writer and
// a fixed summation order: no atomics, deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_common.cuh"

namespace {

template <int G, int STEPS, int VEC, class T, class C>
__global__ void __launch_bounds__(spmm::kWarps * 32, spmm::kCtasPerSm)
ell_spmm_kernel(const int* __restrict__ work_beg, const int* __restrict__ work_len,
                const int* __restrict__ work_dst, const int* __restrict__ cols,
                const C* __restrict__ coef, const T* __restrict__ h, T* __restrict__ out,
                float* __restrict__ partial, int n_items, int d) {
  spmm::run_item<G, STEPS, VEC>(work_beg, work_len, work_dst, cols, coef, h, out, partial,
                                n_items, d, /*accumulate=*/false);
}

}  // namespace

// `dtypes` is spmm::by_dtypes's code of h's (and out's) type and coef's;
// `vec` the features per load that kernels.spmm_vec chose.
extern "C" int ell_spmm(const void* work_beg, const void* work_len, const void* work_dst,
                        int n_items, const void* split_rows, const void* split_ptr,
                        int n_split, const void* cols, const void* coef, const void* h,
                        void* out, void* partial, int d, int vec, int dtypes, void* stream) {
  const spmm::Args a = spmm::make_args(work_beg, work_len, work_dst, n_items, cols, coef, h,
                                       out, partial, d, /*accumulate=*/0, stream);
  return static_cast<int>(spmm::by_dtypes(dtypes, [&](auto t, auto c) {
    using T = typename decltype(t)::type;
    using C = typename decltype(c)::type;
    return spmm::run<T>(a, vec, split_rows, split_ptr, n_split, [&](auto g, auto steps, auto v) {
      ell_spmm_kernel<decltype(g)::value, decltype(steps)::value, decltype(v)::value, T, C>
          <<<spmm::blocks_of(a), spmm::kWarps * 32, 0, a.stream>>>(
              a.beg, a.len, a.dst, a.cols, static_cast<const C*>(a.coef),
              static_cast<const T*>(a.h), static_cast<T*>(a.out), a.partial, a.n_items, a.d);
    });
  }));
}
