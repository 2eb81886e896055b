// Kernel 2: row-parallel CSR SpMM for the residual half of an adjacency pass.
//
//   out[i, f] = (accumulate ? out[i, f] : 0) + sum_{e in row i} coef[e] * h[cols[e], f]
//
// Replaces the residual aggregation of the JAX package, which is XLA rather
// than Pallas there: _segment_apply and, above 49,152 nodes, _blocked2d_apply
// over the flat bucketed piece layout (cuda_gcn_tpu/ops/graphsum.py:42,136).
// The piece layout worked around TPU gather and segment-sum costs; on the card
// the residual is plain CSR.
//
// Design: a CTA of 32 warps owns 32 consecutive rows; lanes run over features
// (three 32-wide steps cover d <= 96, wider d loops). A warp first sums its
// own row if the row has at most kLongRow edges. The rows above that (hubs:
// the reddit residual has a row of 37,181 edges, mean 19) are then taken one
// at a time by all 32 warps of the CTA, each over a contiguous slice of the
// edges, and the 32 partial sums are added in warp order from shared memory.
// A warp loads 32 edges' (col, coef) at once and broadcasts them with
// shuffles; the gathers of 4 edges are issued before their FMAs, so a warp has
// 4 row reads in flight. Sums are taken in f32 registers from zero and added
// to out once: no atomics, so the result is deterministic (index_add_ on the
// card is not).
//
// Bound on the H100: bytes. Each edge reads 8 bytes of index and value and one
// gathered row of h; the least traffic is every input read once and out
// written once, and the random row gathers sit far above that floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;     // warps (and rows) per CTA
constexpr int kSteps = 3;      // 32-wide feature steps per pass over the edges
constexpr int kWidth = 32 * kSteps;
constexpr int kLongRow = 256;  // rows above this many edges use the whole CTA
constexpr int kIlp = 4;        // gathers in flight per warp

// acc[s] (lane's features f0 + 32 s + lane) += sum over edges [beg, end)
__device__ __forceinline__ void row_sum(const int* __restrict__ cols,
                                        const float* __restrict__ coef,
                                        const float* __restrict__ h, int d, int f0,
                                        int beg, int end, int lane, float acc[kSteps]) {
  for (int e0 = beg; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    int c = 0;
    float w = 0.f;
    if (e < end) {
      c = cols[e];
      w = coef[e];
    }
    const int m = min(32, end - e0);
    for (int k = 0; k < m; k += kIlp) {
      float wk[kIlp];
      float hv[kIlp][kSteps];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int ck = __shfl_sync(0xffffffffu, c, k + u);
        wk[u] = __shfl_sync(0xffffffffu, w, k + u);
        const float* hrow = h + (int64_t)ck * d;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int f = f0 + s * 32 + lane;
          hv[u][s] = (k + u < m && f < d) ? hrow[f] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
          if (k + u < m) acc[s] = fmaf(wk[u], hv[u][s], acc[s]);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
csr_spmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ cols,
                const float* __restrict__ coef, const float* __restrict__ h,
                float* __restrict__ out, int n, int d, int accumulate) {
  __shared__ float part[kWarps][kWidth];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kWarps;
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    // rows of at most kLongRow edges: one warp each
    const int row = row0 + warp;
    if (row < n) {
      const int beg = row_ptr[row], end = row_ptr[row + 1];
      if (end - beg <= kLongRow) {
        float acc[kSteps] = {0.f, 0.f, 0.f};
        row_sum(cols, coef, h, d, f0, beg, end, lane, acc);
        float* orow = out + (int64_t)row * d;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int f = f0 + s * 32 + lane;
          if (f < d) orow[f] = accumulate ? orow[f] + acc[s] : acc[s];
        }
      }
    }
    // longer rows: all warps of the CTA, one row at a time (uniform branch)
    for (int w = 0; w < kWarps && row0 + w < n; ++w) {
      const int r = row0 + w;
      const int beg = row_ptr[r], end = row_ptr[r + 1];
      if (end - beg <= kLongRow) continue;
      const int chunk = (end - beg + kWarps - 1) / kWarps;
      const int my_beg = min(end, beg + warp * chunk);
      const int my_end = min(end, my_beg + chunk);
      float acc[kSteps] = {0.f, 0.f, 0.f};
      row_sum(cols, coef, h, d, f0, my_beg, my_end, lane, acc);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) part[warp][s * 32 + lane] = acc[s];
      __syncthreads();
      if (threadIdx.x < kWidth && f0 + threadIdx.x < d) {
        float sum = 0.f;
        for (int q = 0; q < kWarps; ++q) sum += part[q][threadIdx.x];
        float* o = out + (int64_t)r * d + f0 + threadIdx.x;
        *o = accumulate ? *o + sum : sum;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int csr_spmm(const void* row_ptr, const void* cols, const void* coef,
                        const void* h, void* out, int n, int d, int accumulate,
                        void* stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  csr_spmm_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const float*>(coef), static_cast<const float*>(h),
      static_cast<float*>(out), n, d, accumulate);
  return static_cast<int>(cudaGetLastError());
}
