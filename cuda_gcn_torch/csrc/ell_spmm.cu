// Kernel 3: bucketed-ELL SpMM over a flat work list, every bucket in one launch.
//
//   out[rows_b[r], f] = sum_{k < W_b} coef_b[r, k] * h[cols_b[r, k], f]
//
// Replaces the TPU kernel _ell_kernel (cuda_gcn_tpu/ops/pallas_spmm.py:67),
// which pins h in VMEM and walks [TR, 64] index tiles of one bucket per
// pallas_call. On the card h is read from device memory and L2, and one launch
// covers every bucket: the host (ops/ell.py ell_plan) flattens the buckets into
// one slot array and lists work items, each a row's real slots, or a chunk of
// at most 256 slots of a wider row.
//
// Design: one warp per work item; the warp's sum (slot_sum) and the reduce
// kernel are shared with kernel 2 (spmm_common.cuh). The feature width d sets how the 32 lanes
// split: G lanes per slot (G = 4, 8, 16 for d <= 4, 8, 16; else 32) and 32/G
// slots side by side, so that d = 3 does not idle 29 lanes. A warp loads 32
// slots' (col, coef) at once and broadcasts them with shuffles, with 4 row
// gathers in flight per slot group; the groups' sums are added by an xor
// butterfly. An item of a whole row writes its output row once; the chunks of
// a wide row (synth-reddit has one of 43,403 edges) write partial sums, and a
// second kernel adds each row's partials in chunk order. Every output row has
// one writer and a fixed summation order: no atomics, deterministic.
//
// Bound on the H100: bytes. The least traffic is each slot's index and value
// once, h once and out once; the row gathers of h repeat far above that floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_common.cuh"

namespace {

using spmm::kWarps;
constexpr int kIlp = 4;  // row gathers in flight per slot group

template <int G, int STEPS>
__global__ void __launch_bounds__(kWarps * 32)
ell_spmm_kernel(const int* __restrict__ work_beg, const int* __restrict__ work_len,
                const int* __restrict__ work_dst, const int* __restrict__ cols,
                const float* __restrict__ coef, const float* __restrict__ h,
                float* __restrict__ out, float* __restrict__ partial, int n_items,
                int d) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp leaves together
  const int beg = work_beg[item], len = work_len[item], dst = work_dst[item];
  float* orow = dst >= 0 ? out + (int64_t)dst * d : partial + (int64_t)(-dst - 1) * d;
  for (int f0 = 0; f0 < d; f0 += G * STEPS) {
    float acc[STEPS];
    spmm::slot_sum<G, STEPS, 1, kIlp>(cols, coef, h, d, f0, beg, len, lane, acc);
    if (lane < G) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int f = f0 + s * G + lane;
        if (f < d) orow[f] = acc[s];
      }
    }
  }
}

template <int G, int STEPS>
void launch(const int* beg, const int* len, const int* dst, const int* cols,
            const float* coef, const float* h, float* out, float* partial, int n_items,
            int d, cudaStream_t stream) {
  const int blocks = (n_items + kWarps - 1) / kWarps;
  ell_spmm_kernel<G, STEPS><<<blocks, kWarps * 32, 0, stream>>>(
      beg, len, dst, cols, coef, h, out, partial, n_items, d);
}

}  // namespace

extern "C" int ell_spmm(const void* work_beg, const void* work_len, const void* work_dst,
                        int n_items, const void* split_rows, const void* split_ptr,
                        int n_split, const void* cols, const void* coef, const void* h,
                        void* out, void* partial, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto beg = static_cast<const int*>(work_beg);
  auto len = static_cast<const int*>(work_len);
  auto dst = static_cast<const int*>(work_dst);
  auto c = static_cast<const int*>(cols);
  auto w = static_cast<const float*>(coef);
  auto x = static_cast<const float*>(h);
  auto o = static_cast<float*>(out);
  auto p = static_cast<float*>(partial);
  if (n_items > 0) {
    if (d <= 4)
      launch<4, 1>(beg, len, dst, c, w, x, o, p, n_items, d, s);
    else if (d <= 8)
      launch<8, 1>(beg, len, dst, c, w, x, o, p, n_items, d, s);
    else if (d <= 16)
      launch<16, 1>(beg, len, dst, c, w, x, o, p, n_items, d, s);
    else if (d <= 32)
      launch<32, 1>(beg, len, dst, c, w, x, o, p, n_items, d, s);
    else if (d <= 64)
      launch<32, 2>(beg, len, dst, c, w, x, o, p, n_items, d, s);
    else
      launch<32, 3>(beg, len, dst, c, w, x, o, p, n_items, d, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(spmm::reduce_partials(
      static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr), p, o, n_split,
      d, /*accumulate=*/0, s));
}
