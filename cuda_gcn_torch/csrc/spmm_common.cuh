// What the gather SpMM kernels share: kernel 2 (csr_spmm.cu, CSR rows) and
// kernel 3 (ell_spmm.cu, bucketed-ELL rows) both walk a work list with one warp
// per item (ops/ell.py work_list) and differ only in where the slots come from
// and in how a row is stored.
//
//   slot_sum                a warp's sum over an item's slots of coef * h[col]
//   reduce_partials_kernel  adds the partial sums of each chunked row, in
//                           chunk order, into its output row
//
// The feature width d sets how the 32 lanes split: G lanes per slot and 32/G
// slots side by side, each lane holding STEPS pieces of VEC consecutive
// features (VEC = 2 or 4 loads a row of h in 8- or 16-byte pieces; it needs
// d % VEC == 0 and a base aligned to 4 VEC bytes). A warp loads 32 slots'
// (col, coef) at once and broadcasts them with shuffles, with ILP row gathers
// in flight per slot group; the groups' sums are added by an xor butterfly, so
// the order of additions is fixed: no atomics, the same bits on every run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace spmm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps (work items) per CTA

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// acc[s * VEC + v] = sum over slots [beg, beg+len) of
// coef * h[col, f0 + (s * G + lane % G) * VEC + v], identical in every slot
// group after the butterfly.
template <int G, int STEPS, int VEC, int ILP>
__device__ __forceinline__ void slot_sum(const int* __restrict__ cols,
                                         const float* __restrict__ coef,
                                         const float* __restrict__ h, int d, int f0,
                                         int beg, int len, int lane,
                                         float (&acc)[STEPS * VEC]) {
  constexpr int P = 32 / G;  // slots side by side
  constexpr int W = STEPS * VEC;
  static_assert(32 % (P * ILP) == 0, "a batch of 32 slots is whole rounds of P * ILP");
  const int grp = lane / G, sub = lane % G;
#pragma unroll
  for (int s = 0; s < W; ++s) acc[s] = 0.f;
  for (int e0 = 0; e0 < len; e0 += 32) {
    int c = 0;
    float w = 0.f;
    if (e0 + lane < len) {
      c = cols[beg + e0 + lane];
      w = coef[beg + e0 + lane];
    }
    const int m = min(32, len - e0);
    // 32 is a multiple of P * ILP, so j stays below 32
    for (int k = 0; k < m; k += P * ILP) {
      float wk[ILP];
      float hv[ILP][W];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int j = k + u * P + grp;
        const int cj = __shfl_sync(kFull, c, j);
        wk[u] = __shfl_sync(kFull, w, j);
        const float* hrow = h + (int64_t)cj * d;
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          const int f = f0 + (s * G + sub) * VEC;
          if (j < m && f < d) {
            load_vec<VEC>(hrow + f, &hv[u][s * VEC]);
          } else {
#pragma unroll
            for (int v = 0; v < VEC; ++v) hv[u][s * VEC + v] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u)
#pragma unroll
        for (int s = 0; s < W; ++s)
          if (k + u * P + grp < m) acc[s] = fmaf(wk[u], hv[u][s], acc[s]);
    }
  }
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int s = 0; s < W; ++s) acc[s] += __shfl_xor_sync(kFull, acc[s], off);
}

// out[split_rows[i]] (+)= sum of partials [split_ptr[i], split_ptr[i+1]) in order.
__global__ void __launch_bounds__(kWarps * 32)
reduce_partials_kernel(const int* __restrict__ split_rows,
                       const int* __restrict__ split_ptr,
                       const float* __restrict__ partial, float* __restrict__ out,
                       int n_split, int d, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_split) return;
  const int p0 = split_ptr[i], p1 = split_ptr[i + 1];
  float* orow = out + (int64_t)split_rows[i] * d;
  for (int f = lane; f < d; f += 32) {
    float sum = 0.f;
    for (int p = p0; p < p1; ++p) sum += partial[(int64_t)p * d + f];
    orow[f] = accumulate ? orow[f] + sum : sum;
  }
}

inline cudaError_t reduce_partials(const int* split_rows, const int* split_ptr,
                                   const float* partial, float* out, int n_split, int d,
                                   int accumulate, cudaStream_t stream) {
  if (n_split > 0) {
    reduce_partials_kernel<<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
        split_rows, split_ptr, partial, out, n_split, d, accumulate);
  }
  return cudaGetLastError();
}

}  // namespace spmm
