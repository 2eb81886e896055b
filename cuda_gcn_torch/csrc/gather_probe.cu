// Probe kernels of the two primitives every aggregation kernel here is made
// of: random row gathers, and per-edge accumulation into rows.
//
//   gather_probe:  out[0, f] = sum_{i < m} h[idx[i], f]
//   scatter_probe: out[r, f] = sum_{i < mb, idx[i] == r} coef[i] * h[i mod rows, f]
//                  over sorted idx, out [rows, d] starting at zero
//
// Replace the TPU probes gather_kernel and scatter_kernel
// (scripts/exp_pallas_gather.py:60,85), which measured an in-VMEM jnp.take and
// a per-edge dynamic-index read-modify-write on the TPU. Here h is read from
// device memory and L2.
//
// gather_probe: each CTA sums a contiguous slice of idx, each warp a
// contiguous part of that slice with lanes over features and 4 row gathers in
// flight; the CTA adds its warps in order into one partial row, and a second
// kernel adds the CTAs' partial rows in order. Bound on the H100: bytes (idx
// and h once); the gathers themselves are served mostly from L2.
//
// scatter_probe: the TPU loop's read-modify-writes become a segmented sum:
// one warp per output row finds its segment of the sorted idx by binary
// search and adds the segment's terms in index order, lanes over features.
// Every output row has one writer (rows with no term are written 0): no
// atomics, deterministic. Products and sums are rounded separately (no FMA),
// as the TPU loop's out += coef * g rounds them. Bound: bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per CTA
constexpr int kSteps = 4;   // 32-wide feature steps per pass: 128 features
constexpr int kWidth = 32 * kSteps;
constexpr int kIlp = 4;     // row gathers in flight per warp

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__global__ void __launch_bounds__(kWarps * 32)
gather_partial_kernel(const int* __restrict__ idx, const float* __restrict__ h,
                      float* __restrict__ partial, int64_t m, int64_t per_block, int d) {
  __shared__ float part[kWarps][kWidth];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b0 = blockIdx.x * per_block;
  const int64_t b1 = min64(m, b0 + per_block);
  const int64_t per_warp = (per_block + kWarps - 1) / kWarps;
  const int64_t w0 = min64(b1, b0 + warp * per_warp);
  const int64_t w1 = min64(b1, w0 + per_warp);
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    float acc[kSteps] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t e0 = w0; e0 < w1; e0 += 32) {
      const int r = e0 + lane < w1 ? idx[e0 + lane] : 0;
      const int cnt = (int)min64(32, w1 - e0);
      for (int k = 0; k < cnt; k += kIlp) {
        float hv[kIlp][kSteps];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const float* hrow = h + (int64_t)__shfl_sync(kFull, r, (k + u) & 31) * d;
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            const int f = f0 + s * 32 + lane;
            hv[u][s] = (k + u < cnt && f < d) ? hrow[f] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u)
#pragma unroll
          for (int s = 0; s < kSteps; ++s)
            if (k + u < cnt) acc[s] += hv[u][s];
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) part[warp][s * 32 + lane] = acc[s];
    __syncthreads();
    if (threadIdx.x < kWidth && f0 + threadIdx.x < d) {
      float sum = 0.f;
      for (int q = 0; q < kWarps; ++q) sum += part[q][threadIdx.x];
      partial[(int64_t)blockIdx.x * d + f0 + threadIdx.x] = sum;
    }
    __syncthreads();
  }
}

__global__ void gather_final_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int blocks, int d) {
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    float sum = 0.f;
    for (int b = 0; b < blocks; ++b) sum += partial[(int64_t)b * d + f];
    out[f] = sum;
  }
}

// first i in [0, n) with idx[i] >= key
__device__ __forceinline__ int first_at_least(const int* __restrict__ idx, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (idx[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ coef,
               const float* __restrict__ h, float* __restrict__ out, int rows, int mb,
               int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lo = first_at_least(idx, mb, r), hi = first_at_least(idx, mb, r + 1);
  float* orow = out + (int64_t)r * d;
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    float acc[kSteps] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = lo; i0 < hi; i0 += kIlp) {
      float wk[kIlp];
      float hv[kIlp][kSteps];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = i0 + u;
        wk[u] = i < hi ? coef[i] : 0.f;
        const float* hrow = h + (int64_t)(i % rows) * d;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int f = f0 + s * 32 + lane;
          hv[u][s] = (i < hi && f < d) ? hrow[f] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
          if (i0 + u < hi) acc[s] = __fadd_rn(acc[s], __fmul_rn(wk[u], hv[u][s]));
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int f = f0 + s * 32 + lane;
      if (f < d) orow[f] = acc[s];
    }
  }
}

}  // namespace

extern "C" int gather_probe(const void* idx, const void* h, void* partial, void* out,
                            int64_t m, int blocks, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t per_block = (m + blocks - 1) / blocks;
  gather_partial_kernel<<<blocks, kWarps * 32, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const float*>(h),
      static_cast<float*>(partial), m, per_block, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_final_kernel<<<1, kWarps * 32, 0, s>>>(static_cast<const float*>(partial),
                                                static_cast<float*>(out), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scatter_probe(const void* idx, const void* coef, const void* h, void* out,
                             int rows, int mb, int d, void* stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  scatter_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(coef),
      static_cast<const float*>(h), static_cast<float*>(out), rows, mb, d);
  return static_cast<int>(cudaGetLastError());
}
