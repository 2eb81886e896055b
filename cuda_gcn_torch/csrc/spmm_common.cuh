// The gather SpMM that kernel 2 (csr_spmm.cu, the rows of a CSR) and kernel 3
// (ell_spmm.cu, the rows of a bucketed ELL) both are. The two walk a work list
// with one warp per item (ops/ell.py work_list) and differ only in where an
// item's slots lie, which the host decides, and in whether the sum is added to
// what the output row holds. So the body is here once:
//
//   run_item                the whole of a warp's work on one item
//   slot_sum                its sum over the item's slots of coef * h[col]
//   by_width                the host's choice of the lane split for a width d
//   reduce_partials_kernel  adds the partial sums of each chunked row, in
//                           chunk order, into its output row
//
// Bound on the H100: bytes, and within that the row gathers of h. Read once,
// the operands are small (synth-reddit at d = 82: 168 MB of slots, 76 MB of h,
// 76 MB of out), but every slot gathers a row of h: 21 M rows of 328 bytes are
// 6.9 GB, 2.05 ms from device memory alone against 0.10 ms for the bytes read
// once. The kernel therefore runs at the rate at which L2 and device memory
// serve random rows, and the design is about keeping as many row gathers in
// flight on every SM as the SM can hold, in as few instructions as possible:
//
// * The feature width d sets how the 32 lanes split: G lanes per slot and 32/G
//   slots side by side, each lane holding STEPS pieces of VEC consecutive
//   features. VEC is the widest load that d and the bases of h, out and the
//   partials allow (the launcher decides: 4 at d = 16 and 32, where a row of h
//   is 4 or 8 lanes of 16 bytes and 8 or 4 slots are gathered side by side; 2
//   at d = 82, 41 lanes' 8-byte loads in two steps; 1 at an odd d). A wide
//   load is a quarter of the load and shuffle instructions per edge.
// * Occupancy before depth: one gather in flight per slot group and 32
//   registers a thread, so that 64 warps fit an SM (__launch_bounds__ asks for
//   8 CTAs of 8 warps). An item is a chain of three dependent loads (item,
//   slots, rows), and more warps hide it better than deeper batches do: on the
//   reddit shapes 64 warps with one gather each beat 24 warps with 8 on kernel
//   2 and 4 on kernel 3.
// * A warp loads 32 slots' (col, coef) at once, coalesced, and broadcasts them
//   with shuffles; the slot groups' sums are added by an xor butterfly, and a
//   row of the output is stored in VEC-wide pieces.
// * The caches are for h. A pass streams 8 bytes per slot (168 MB on
//   synth-reddit) that are used once, through the L1 and the 50 MB L2 that
//   should keep the rows of h, so the slots are loaded as streaming data
//   (ld.global.cs: first to be evicted). Worth 2-6% on the reddit shapes. An
//   evict-last policy on the rows of h was measured too and costs 2-25%.
//
// Every output row has one writer and a fixed order of additions: no atomics,
// the same bits on every run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace spmm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;      // warps (work items) per CTA
constexpr int kCtasPerSm = 8;  // asked of the compiler: 64 warps an SM, 32 registers a thread
constexpr int kIlp = 1;        // row gathers in flight per slot group

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
      c = __ldcs(cols + beg + e0 + lane);  // read once: first to leave the caches
      w = __ldcs(coef + beg + e0 + lane);
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

// One warp's item: the sum over its slots, stored to its output row (added to
// what the row holds when `accumulate`) or to its partial, which starts from
// zero. The caller's kernel has kWarps warps a CTA and one item a warp.
template <int G, int STEPS, int VEC>
__device__ __forceinline__ void run_item(const int* __restrict__ work_beg,
                                         const int* __restrict__ work_len,
                                         const int* __restrict__ work_dst,
                                         const int* __restrict__ cols,
                                         const float* __restrict__ coef,
                                         const float* __restrict__ h, float* __restrict__ out,
                                         float* __restrict__ partial, int n_items, int d,
                                         bool accumulate) {
  constexpr int W = STEPS * VEC;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp leaves together
  const int beg = work_beg[item], len = work_len[item], dst = work_dst[item];
  float* orow = dst >= 0 ? out + (int64_t)dst * d : partial + (int64_t)(-dst - 1) * d;
  const bool add = accumulate && dst >= 0;
  for (int f0 = 0; f0 < d; f0 += G * W) {
    float acc[W];
    // at most G in flight: a batch of 32 slots is whole rounds of 32 / G * ILP
    slot_sum<G, STEPS, VEC, (kIlp < G ? kIlp : G)>(cols, coef, h, d, f0, beg, len, lane, acc);
    if (lane < G) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int f = f0 + (s * G + lane) * VEC;
        if (f < d) {
          if (add) {
            float old[VEC];
            load_vec<VEC>(orow + f, old);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[s * VEC + v] += old[v];
          }
          store_vec<VEC>(orow + f, &acc[s * VEC]);
        }
      }
    }
  }
}

// What a launch of either kernel is given.
struct Args {
  const int *beg, *len, *dst, *cols;
  const float *coef, *h;
  float *out, *partial;
  int n_items, d, accumulate;
  cudaStream_t stream;
};

inline Args make_args(const void* work_beg, const void* work_len, const void* work_dst,
                      int n_items, const void* cols, const void* coef, const void* h,
                      void* out, void* partial, int d, int accumulate, void* stream) {
  return Args{static_cast<const int*>(work_beg), static_cast<const int*>(work_len),
              static_cast<const int*>(work_dst), static_cast<const int*>(cols),
              static_cast<const float*>(coef),   static_cast<const float*>(h),
              static_cast<float*>(out),          static_cast<float*>(partial),
              n_items, d, accumulate, static_cast<cudaStream_t>(stream)};
}

inline int blocks_of(const Args& a) { return (a.n_items + kWarps - 1) / kWarps; }

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether rows of d floats at the bases of h, out and the partials can be read
// and written in pieces of `vec` floats. The launcher chooses vec
// (kernels.spmm_vec); a vec that does not fit is refused, not launched.
inline bool vec_fits(const Args& a, int vec) {
  return (vec == 1 || vec == 2 || vec == 4) && a.d % vec == 0 && aligned(a.h, 4 * vec) &&
         aligned(a.out, 4 * vec) && aligned(a.partial, 4 * vec);
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls launch(Int<G>, Int<STEPS>, Int<VEC>) for the lane split of width d at
// load width vec: G lanes of VEC features cover a row of d = dv * VEC features
// in STEPS steps; wider rows loop.
template <int VEC, class Launch>
void by_lanes(int d, Launch&& launch) {
  const int dv = d / VEC;
  if (dv <= 4)
    launch(Int<4>{}, Int<1>{}, Int<VEC>{});
  else if (dv <= 8)
    launch(Int<8>{}, Int<1>{}, Int<VEC>{});
  else if (dv <= 16)
    launch(Int<16>{}, Int<1>{}, Int<VEC>{});
  else if (dv <= 32)
    launch(Int<32>{}, Int<1>{}, Int<VEC>{});
  else if (dv <= 64)
    launch(Int<32>{}, Int<2>{}, Int<VEC>{});
  else
    launch(Int<32>{}, Int<3>{}, Int<VEC>{});
}

template <class Launch>
void by_width(int d, int vec, Launch&& launch) {
  if (vec == 4)
    by_lanes<4>(d, launch);
  else if (vec == 2)
    by_lanes<2>(d, launch);
  else
    by_lanes<1>(d, launch);
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
