// Kernel 1: block-sparse tile contraction for the dense half of an adjacency
// pass.
//
//   out[r*tb + i, f] = sum over slots p of row r, sum over j of
//                      A_p[i, j] * h[hblk[p]*tb + j, f]
//
// where A_p is tile order[p] ([tb, tb], bf16 or f32) or its transpose, and
// slots [ptr[r], ptr[r+1]) are the tiles of output block row r.
//
// Replaces the TPU kernels _bsr_kernel and _bsr_kernel_resident
// (cuda_gcn_tpu/ops/pallas_bsr.py:65,120). The two TPU variants differ only in
// where the TPU kept the activation block (one streamed block, or the whole
// table resident in VMEM); on the card that is a detail of this kernel's
// design, so one kernel serves both. It also covers the transpose
// orientation, which the JAX package leaves on XLA
// (cuda_gcn_tpu/ops/graphsum.py:229).
//
// Design (simple and correct first). The TPU grid runs in order and carries a
// [dp, tb] accumulator from tile to tile; a Hopper grid does not. So one CTA
// owns one (block row, 32-wide feature chunk) and loops over that row's tiles,
// keeping the [tb, 32] output block in f32 registers (128 threads, 2 rows
// each). It walks each tile 32 columns at a time. A step stages the [tb, 32]
// slice of A (upcast to f32) and the [32, 32] slice of h in shared memory,
// then each thread does 2 x 32 IEEE f32 FMAs per column (no TF32: parity with
// the f32 JAX path). The next step's slices are loaded into registers with
// 16-byte loads, all issued together, while the current step computes, so the
// memory latency is paid once per step and hidden behind the FMAs. The tile
// slice is stored with a row stride of 33 floats, so each thread reading its
// own row at the same column hits a distinct bank. Every output row is written
// once, with no atomics, so the result is deterministic; a block row with no
// tiles writes zeros. Rows and features past n and d are masked (the JAX
// version pads h instead); the tile offset is computed in 64 bits (K*tb*tb
// passes 2^31 at 4x reddit).
//
// Bound on the H100: at the reddit shapes it does 2*K*tb*tb*d f32 operations
// (236 GFLOP at d=82) on CUDA cores, which take longer than streaming the
// 2.88 GB of bf16 tiles, so it is bound by operations. Tensor cores would need
// bf16 or TF32 activations, which breaks f32 parity; that trade is left to a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerThread = 2;
constexpr int kMaxTb = kThreads * kRowsPerThread;  // 256
constexpr int kFeat = 32;                          // feature chunk per CTA
constexpr int kJ = 32;                             // tile columns per step
constexpr int kTsStride = kJ + 1;
constexpr int kHPerThread = kJ * kFeat / kThreads;  // 8

__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// Element e of a 16-byte vector as f32 (e is a compile-time index after
// unrolling, so the vector stays in registers).
template <typename TileT>
__device__ __forceinline__ float elem(const uint4& v, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  const uint32_t w = word(v, e >> 1);  // bf16 -> f32 is exact: the high half
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <typename TileT>
struct Staged {
  static constexpr int kPerVec = 16 / sizeof(TileT);  // elements per 16-byte load
  static constexpr int kVecs = kMaxTb * kJ / kPerVec / kThreads;
  uint4 tile[kVecs];
  float h[kHPerThread];
};

// Registers <- the step's [tb, 32] slice of A and [32, 32] slice of h.
template <typename TileT>
__device__ __forceinline__ void load_step(Staged<TileT>& st, const TileT* tile,
                                          int64_t hrow0, int j0, int tb, int transpose,
                                          const float* __restrict__ h, int n, int d,
                                          int f0, int t) {
  constexpr int kPerVec = Staged<TileT>::kPerVec;
  const int nvec = tb * kJ / kPerVec;
#pragma unroll
  for (int q = 0; q < Staged<TileT>::kVecs; ++q) {
    const int v = t + q * kThreads;
    if (v < nvec) {
      int64_t off;
      if (!transpose) {  // rows i of the tile, columns j0..j0+31
        const int i = v / (kJ / kPerVec), part = v % (kJ / kPerVec);
        off = (int64_t)i * tb + j0 + part * kPerVec;
      } else {           // rows j0..j0+31 of the tile, all tb columns
        const int jj = v / (tb / kPerVec), part = v % (tb / kPerVec);
        off = (int64_t)(j0 + jj) * tb + part * kPerVec;
      }
      st.tile[q] = *reinterpret_cast<const uint4*>(tile + off);
    }
  }
#pragma unroll
  for (int q = 0; q < kHPerThread; ++q) {
    const int e = t + q * kThreads;
    const int jj = e / kFeat, ff = e % kFeat;
    const int64_t row = hrow0 + j0 + jj;
    const int f = f0 + ff;
    st.h[q] = (row < n && f < d) ? h[row * d + f] : 0.f;
  }
}

// Shared memory <- registers: ts[i][jj] = A[i][j0 + jj] (as f32), hs[jj][ff].
template <typename TileT>
__device__ __forceinline__ void store_step(const Staged<TileT>& st, float* ts, float* hs,
                                           int tb, int transpose, int t) {
  constexpr int kPerVec = Staged<TileT>::kPerVec;
  const int nvec = tb * kJ / kPerVec;
#pragma unroll
  for (int q = 0; q < Staged<TileT>::kVecs; ++q) {
    const int v = t + q * kThreads;
    if (v < nvec) {
      if (!transpose) {
        const int i = v / (kJ / kPerVec), jj0 = (v % (kJ / kPerVec)) * kPerVec;
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) ts[i * kTsStride + jj0 + e] = elem<TileT>(st.tile[q], e);
      } else {
        const int jj = v / (tb / kPerVec), i0 = (v % (tb / kPerVec)) * kPerVec;
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) ts[(i0 + e) * kTsStride + jj] = elem<TileT>(st.tile[q], e);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kHPerThread; ++q) hs[t + q * kThreads] = st.h[q];
}

template <typename TileT>
__global__ void __launch_bounds__(kThreads)
bsr_tile_kernel(const int* __restrict__ ptr, const int* __restrict__ order,
                const int* __restrict__ hblk, const TileT* __restrict__ tiles,
                const float* __restrict__ h, float* __restrict__ out, int n,
                int d, int tb, int transpose) {
  __shared__ float ts[kMaxTb * kTsStride];
  __shared__ __align__(16) float hs[kJ * kFeat];

  const int r = blockIdx.y;
  const int f0 = blockIdx.x * kFeat;
  const int t = threadIdx.x;

  // rows tb..kMaxTb-1 are never staged; zero them once so the unused
  // accumulators stay finite (they are not stored)
  for (int e = tb * kTsStride + t; e < kMaxTb * kTsStride; e += kThreads) ts[e] = 0.f;

  float acc[kRowsPerThread][kFeat];
#pragma unroll
  for (int s = 0; s < kRowsPerThread; ++s)
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[s][f] = 0.f;

  const int64_t tile_elems = (int64_t)tb * tb;
  const int beg = ptr[r];
  const int nj = tb / kJ;
  const int steps = (ptr[r + 1] - beg) * nj;
  Staged<TileT> st;
  if (steps > 0)
    load_step(st, tiles + (int64_t)order[beg] * tile_elems, (int64_t)hblk[beg] * tb, 0,
              tb, transpose, h, n, d, f0, t);
  for (int s = 0; s < steps; ++s) {
    store_step(st, ts, hs, tb, transpose, t);
    __syncthreads();
    if (s + 1 < steps) {  // next step's loads fly while this one computes
      const int p = beg + (s + 1) / nj;
      load_step(st, tiles + (int64_t)order[p] * tile_elems, (int64_t)hblk[p] * tb,
                ((s + 1) % nj) * kJ, tb, transpose, h, n, d, f0, t);
    }
#pragma unroll 4
    for (int jj = 0; jj < kJ; ++jj) {
      float a[kRowsPerThread];
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q)
        a[q] = ts[(t + q * kThreads) * kTsStride + jj];
      const float4* hv = reinterpret_cast<const float4*>(hs + jj * kFeat);
#pragma unroll
      for (int q = 0; q < kFeat / 4; ++q) {
        const float4 x = hv[q];
#pragma unroll
        for (int u = 0; u < kRowsPerThread; ++u) {
          acc[u][4 * q + 0] = fmaf(a[u], x.x, acc[u][4 * q + 0]);
          acc[u][4 * q + 1] = fmaf(a[u], x.y, acc[u][4 * q + 1]);
          acc[u][4 * q + 2] = fmaf(a[u], x.z, acc[u][4 * q + 2]);
          acc[u][4 * q + 3] = fmaf(a[u], x.w, acc[u][4 * q + 3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < kRowsPerThread; ++s) {
    const int i = t + s * kThreads;
    const int64_t row = (int64_t)r * tb + i;
    if (i < tb && row < n) {
#pragma unroll
      for (int ff = 0; ff < kFeat; ++ff) {
        const int f = f0 + ff;
        if (f < d) out[row * d + f] = acc[s][ff];
      }
    }
  }
}

}  // namespace

extern "C" int bsr_tile_contract(const void* ptr, const void* order,
                                 const void* hblk, const void* tiles,
                                 int tiles_bf16, const void* h, void* out, int n,
                                 int d, int tb, int t_blocks, int transpose,
                                 void* stream) {
  const dim3 grid((d + kFeat - 1) / kFeat, t_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* o = static_cast<const int*>(order);
  const int* hb = static_cast<const int*>(hblk);
  const float* hf = static_cast<const float*>(h);
  float* of = static_cast<float*>(out);
  if (tiles_bf16) {
    bsr_tile_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        p, o, hb, static_cast<const __nv_bfloat16*>(tiles), hf, of, n, d, tb, transpose);
  } else {
    bsr_tile_kernel<float><<<grid, kThreads, 0, s>>>(
        p, o, hb, static_cast<const float*>(tiles), hf, of, n, d, tb, transpose);
  }
  return static_cast<int>(cudaGetLastError());
}
