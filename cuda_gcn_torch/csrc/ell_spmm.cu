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
//
// ell_blend is the same pass with GCNII's initial residual in its store (f32
// alone): out = a * (A h) + b * h0, each output row still written once, and
// the chunked rows' reduction blends as it stores (spmm_common.cuh Blend). A
// pair pass gathers h at the concatenated width 2 * dh and stores each half,
// and reads each half's h0, in tensors of their own. Without h0 it is the
// backward's a * (A^T g). Its kernel has a name of its own, ell_blend_kernel,
// so that a trace tells its launches from ell_spmm's.

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

template <int G, int STEPS, int VEC>
__global__ void __launch_bounds__(spmm::kWarps * 32, spmm::kCtasPerSm)
ell_blend_kernel(const int* __restrict__ work_beg, const int* __restrict__ work_len,
                 const int* __restrict__ work_dst, const int* __restrict__ cols,
                 const float* __restrict__ coef, const float* __restrict__ h,
                 float* __restrict__ out, float* __restrict__ partial, int n_items, int d,
                 spmm::Blend bl) {
  spmm::run_item<G, STEPS, VEC, float, float, true>(work_beg, work_len, work_dst, cols, coef, h,
                                                    out, partial, n_items, d,
                                                    /*accumulate=*/false, bl);
}

}  // namespace

namespace spmm {

// spmm_common.cuh's reduce_partials_kernel for the blended form (f32 rows):
// out[split_rows[i]] = a * (the sum of its partials, in chunk order) + b * h0 of
// that row, each half where the Blend store puts it.
__global__ void __launch_bounds__(kWarps * 32)
reduce_partials_kernel(const int* __restrict__ split_rows,
                       const int* __restrict__ split_ptr,
                       const float* __restrict__ partial, float* __restrict__ out,
                       int n_split, int d, Blend bl) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_split) return;
  const int p0 = split_ptr[i], p1 = split_ptr[i + 1];
  const int64_t row = split_rows[i];
  for (int f = lane; f < d; f += 32) {
    float sum = 0.f;
    for (int p = p0; p < p1; ++p) sum += partial[(int64_t)p * d + f];
    const bool hi = f >= bl.dh;
    const int64_t at = row * bl.dh + (hi ? f - bl.dh : f);
    (hi ? bl.out_hi : out)[at] = bl.h0 != nullptr
                                     ? blend_value(bl, sum, (hi ? bl.h0_hi : bl.h0)[at])
                                     : __fmul_rn(bl.a, sum);
  }
}

// The whole launch of kernel 3's blended form (f32 rows and coefficients):
// the load width checked against h, out and the partials (run's rule) and
// against the halves' bases and width, the items launched by `kernel`, then
// the chunked rows' partials added and blended.
template <class Kernel>
cudaError_t run_blend(const Args& a, int vec, const void* split_rows, const void* split_ptr,
                      int n_split, const Blend& bl, Kernel&& kernel) {
  const int bytes = vec * 4;
  const bool halves = bl.dh == a.d || 2 * bl.dh == a.d;
  if (!vec_fits<float>(a, vec) || !halves || bl.dh % vec != 0 || !aligned(bl.out_hi, bytes) ||
      (bl.h0 != nullptr && (!aligned(bl.h0, bytes) || !aligned(bl.h0_hi, bytes))))
    return cudaErrorInvalidValue;
  if (a.n_items > 0) {
    by_width<float>(a.d, vec, kernel);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_split > 0) {
    reduce_partials_kernel<<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0, a.stream>>>(
        static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr), a.partial,
        static_cast<float*>(a.out), n_split, a.d, bl);
  }
  return cudaGetLastError();
}

}  // namespace spmm

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

// The blended pass over f32 rows: out (columns [0, dh) of each row; with dh = d
// / 2 the columns [dh, d) go to out_hi) = a * sum + b * h0 (h0_hi the same for
// the upper half; h0 null: a * sum). `vec` is kernels.spmm_vec's choice.
extern "C" int ell_blend(const void* work_beg, const void* work_len, const void* work_dst,
                         int n_items, const void* split_rows, const void* split_ptr,
                         int n_split, const void* cols, const void* coef, const void* h,
                         void* out, void* partial, int d, int vec, const void* h0,
                         const void* h0_hi, void* out_hi, int dh, float a, float b,
                         void* stream) {
  const spmm::Args args = spmm::make_args(work_beg, work_len, work_dst, n_items, cols, coef, h,
                                          out, partial, d, /*accumulate=*/0, stream);
  const spmm::Blend bl{static_cast<const float*>(h0), static_cast<const float*>(h0_hi),
                       static_cast<float*>(out_hi), dh, a, b};
  auto launch = [&](auto g, auto steps, auto v) {
    ell_blend_kernel<decltype(g)::value, decltype(steps)::value, decltype(v)::value>
        <<<spmm::blocks_of(args), spmm::kWarps * 32, 0, args.stream>>>(
            args.beg, args.len, args.dst, args.cols, static_cast<const float*>(args.coef),
            static_cast<const float*>(args.h), static_cast<float*>(args.out), args.partial,
            args.n_items, args.d, bl);
  };
  return static_cast<int>(spmm::run_blend(args, vec, split_rows, split_ptr, n_split, bl, launch));
}
