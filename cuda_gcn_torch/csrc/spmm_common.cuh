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
//   features. VEC is the widest load (16, 8 or 4 bytes) that d and the bases
//   of h, out and the partials allow (the launcher decides). For f32 rows: 4
//   at d = 16 and 32, where a row of h is 4 or 8 lanes of 16 bytes and 8 or 4
//   slots are gathered side by side; 2 at d = 82, 41 lanes' 8-byte loads in
//   two steps; 1 at an odd d. For bf16 rows: 8 at d = 16 and 32 (2 or 4 lanes
//   of 16 bytes), 2 at d = 82 (164 bytes a row: 4-byte loads), 1 at d = 41
//   (82 bytes: 2-byte loads). A wide load is a quarter of the load and
//   shuffle instructions per edge.
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
//
// The blended form (kernel 3's ell_blend, GCNII's initial residual) stores
// out = a * sum + b * h0 instead of the sum: the BLEND flag of run_item and its
// Blend store (ell_spmm.cu holds the rest). Without the flag run_item compiles
// as before; only f32 rows take it.
//
// Element types. h and out are of one type T, f32 or bf16; the coefficients of
// type C, f32 or bf16. Rows stay in device memory in their own type and are
// converted to f32 as they are loaded: a bf16 row is half the gathered bytes,
// and a 16-byte load holds 8 of its features. Every sum is taken in f32 and
// rounded to T once, where it is stored; the partial sums of a chunked row are
// f32 and rounded when the second kernel adds them. The adding form (kernel 2
// after kernel 1) reads the old row of out, adds in f32 and stores T once.
// The pairs built are (T, C) = (f32, f32), (f32, bf16) and (bf16, bf16), by
// the code 2 * (T is bf16) + (C is bf16) that the C entries take (by_dtypes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace spmm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;      // warps (work items) per CTA
constexpr int kCtasPerSm = 8;  // asked of the compiler: 64 warps an SM, 32 registers a thread
constexpr int kIlp = 1;        // row gathers in flight per slot group

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <class T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, float>)
    return x;
  else
    return __float2bfloat16_rn(x);
}

// A coefficient, loaded as streaming data (ld.global.cs: first to be evicted).
__device__ __forceinline__ float load_coef(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_coef(const bf16* p) {
  return __uint_as_float(uint32_t(__ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// VEC consecutive elements of type T as one load brought them: raw 32-bit
// words (two bf16 a word, the lower address in the low half), unpacked to f32
// where they are used, so that a bf16 row costs half the registers in flight.
template <class T, int VEC>
struct Raw {
  static constexpr int kBytes = VEC * int(sizeof(T));
  static constexpr int kWords = (kBytes + 3) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes == 16) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (kBytes == 8) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x, w[1] = t.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(w[i]);
    else  // bf16 -> f32 is exact: the high half of the f32's bits
      return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
};

// p[0, VEC) <- v rounded to T, in one store of VEC * sizeof(T) bytes (two for
// 8 floats).
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// acc[s * VEC + v] = sum over slots [beg, beg+len) of
// coef * h[col, f0 + (s * G + lane % G) * VEC + v], identical in every slot
// group after the butterfly.
template <int G, int STEPS, int VEC, int ILP, class T, class C>
__device__ __forceinline__ void slot_sum(const int* __restrict__ cols,
                                         const C* __restrict__ coef,
                                         const T* __restrict__ h, int d, int f0,
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
      w = load_coef(coef + beg + e0 + lane);
    }
    const int m = min(32, len - e0);
    // 32 is a multiple of P * ILP, so j stays below 32
    for (int k = 0; k < m; k += P * ILP) {
      float wk[ILP];
      Raw<T, VEC> hv[ILP][STEPS];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int j = k + u * P + grp;
        const int cj = __shfl_sync(kFull, c, j);
        wk[u] = __shfl_sync(kFull, w, j);
        const T* hrow = h + (int64_t)cj * d;
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
          const int f = f0 + (s * G + sub) * VEC;
          if (j < m && f < d)
            hv[u][s].load(hrow + f);
          else
            hv[u][s].zero();
        }
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u)
#pragma unroll
        for (int s = 0; s < STEPS; ++s)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            if (k + u * P + grp < m)
              acc[s * VEC + v] = fmaf(wk[u], hv[u][s].get(v), acc[s * VEC + v]);
    }
  }
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int s = 0; s < W; ++s) acc[s] += __shfl_xor_sync(kFull, acc[s], off);
}

// Lanes [0, G) store a slot group's sums acc (STEPS pieces of VEC features
// from f0) to `row`, of out's type or the f32 partials; with `add`, each
// piece is first added to what the row holds, in f32, and stored once.
template <int G, int STEPS, int VEC, class O>
__device__ __forceinline__ void store_row(O* __restrict__ row, int f0, int lane, int d,
                                          bool add, float* acc) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int f = f0 + (s * G + lane) * VEC;
    if (f < d) {
      if (add) {
        Raw<O, VEC> old;
        old.load(row + f);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[s * VEC + v] += old.get(v);
      }
      store_vec<VEC>(row + f, &acc[s * VEC]);
    }
  }
}

// The blended store: element f of output row r is a * sum + b * h0[r, f], in
// f32, each product rounded and then their sum (no contraction: the plain
// version's arithmetic), stored once. A pair pass (the training and the
// evaluation halves at the concatenated width d = 2 * dh) keeps each half's h0
// and out in a tensor of its own, rows dh apart: columns [0, dh) in h0 and
// out, [dh, d) in h0_hi and out_hi; a single pass has dh = d. Without h0 (the
// backward's a * A^T g) nothing of it is read and the sum is only scaled.
struct Blend {
  const float* h0;
  const float* h0_hi;
  float* out_hi;
  int dh;
  float a, b;
};

__device__ __forceinline__ float blend_value(const Blend& bl, float sum, float h0) {
  return __fadd_rn(__fmul_rn(bl.a, sum), __fmul_rn(bl.b, h0));
}

// Lanes [0, G) store a slot group's sums acc (STEPS pieces of VEC features
// from f0) of output row `row`, blended; a piece lies within one half, since
// dh is a multiple of VEC.
template <int G, int STEPS, int VEC>
__device__ __forceinline__ void store_blend(const Blend& bl, float* __restrict__ out, int row,
                                            int f0, int lane, int d, float* acc) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int f = f0 + (s * G + lane) * VEC;
    if (f < d) {
      const bool hi = f >= bl.dh;
      const int64_t at = (int64_t)row * bl.dh + (hi ? f - bl.dh : f);
      if (bl.h0 != nullptr) {
        Raw<float, VEC> r;
        r.load((hi ? bl.h0_hi : bl.h0) + at);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[s * VEC + v] = blend_value(bl, acc[s * VEC + v], r.get(v));
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[s * VEC + v] = __fmul_rn(bl.a, acc[s * VEC + v]);
      }
      store_vec<VEC>((hi ? bl.out_hi : out) + at, &acc[s * VEC]);
    }
  }
}

// One warp's item: the sum over its slots, stored to its output row (added to
// what the row holds when `accumulate`; blended where BLEND) or to its f32
// partial, which starts from zero. The caller's kernel has kWarps warps a CTA
// and one item a warp. Only the item's ids stay live across the slot loop; the
// row's address is made where it is stored.
template <int G, int STEPS, int VEC, class T, class C, bool BLEND = false>
__device__ __forceinline__ void run_item(const int* __restrict__ work_beg,
                                         const int* __restrict__ work_len,
                                         const int* __restrict__ work_dst,
                                         const int* __restrict__ cols,
                                         const C* __restrict__ coef,
                                         const T* __restrict__ h, T* __restrict__ out,
                                         float* __restrict__ partial, int n_items, int d,
                                         bool accumulate, const Blend& bl = Blend{}) {
  constexpr int W = STEPS * VEC;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp leaves together
  const int beg = work_beg[item], len = work_len[item], dst = work_dst[item];
  for (int f0 = 0; f0 < d; f0 += G * W) {
    float acc[W];
    // at most G in flight: a batch of 32 slots is whole rounds of 32 / G * ILP
    slot_sum<G, STEPS, VEC, (kIlp < G ? kIlp : G)>(cols, coef, h, d, f0, beg, len, lane, acc);
    if (lane < G) {
      if (dst >= 0) {
        if constexpr (BLEND)
          store_blend<G, STEPS, VEC>(bl, out, dst, f0, lane, d, acc);
        else
          store_row<G, STEPS, VEC>(out + (int64_t)dst * d, f0, lane, d, accumulate, acc);
      } else
        store_row<G, STEPS, VEC>(partial + (int64_t)(-dst - 1) * d, f0, lane, d, false, acc);
    }
  }
}

// What a launch of either kernel is given; h, coef and out are of the types
// that the dtype code names.
struct Args {
  const int *beg, *len, *dst, *cols;
  const void *coef, *h;
  void* out;
  float* partial;
  int n_items, d, accumulate;
  cudaStream_t stream;
};

inline Args make_args(const void* work_beg, const void* work_len, const void* work_dst,
                      int n_items, const void* cols, const void* coef, const void* h,
                      void* out, void* partial, int d, int accumulate, void* stream) {
  return Args{static_cast<const int*>(work_beg), static_cast<const int*>(work_len),
              static_cast<const int*>(work_dst), static_cast<const int*>(cols),
              coef, h, out, static_cast<float*>(partial),
              n_items, d, accumulate, static_cast<cudaStream_t>(stream)};
}

inline int blocks_of(const Args& a) { return (a.n_items + kWarps - 1) / kWarps; }

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether rows of d elements of T at the bases of h and out can be read and
// written in pieces of `vec` elements (16, 8, 4 bytes, or one element), and
// rows of d floats at the base of the partials in pieces of as many floats.
// The launcher chooses vec (kernels.spmm_vec); a vec that does not fit is
// refused, not launched.
template <class T>
bool vec_fits(const Args& a, int vec) {
  const int bytes = vec * int(sizeof(T));
  const bool known = vec == 1 || ((bytes == 4 || bytes == 8 || bytes == 16) && vec > 1);
  const int partial_bytes = vec * 4 < 16 ? vec * 4 : 16;
  return known && a.d % vec == 0 && aligned(a.h, bytes) && aligned(a.out, bytes) &&
         aligned(a.partial, partial_bytes);
}

template <int V>
using Int = std::integral_constant<int, V>;

template <class T>
struct Type {
  using type = T;
};

// Calls launch(Type<T>, Type<C>) for the dtype code 2 * (T is bf16) + (C is
// bf16) of the pairs built; another code is refused.
template <class Launch>
cudaError_t by_dtypes(int code, Launch&& launch) {
  switch (code) {
    case 0: return launch(Type<float>{}, Type<float>{});
    case 1: return launch(Type<float>{}, Type<bf16>{});
    case 3: return launch(Type<bf16>{}, Type<bf16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Calls launch(Int<G>, Int<STEPS>, Int<VEC>) for the lane split of width d at
// load width vec: G lanes of VEC features cover a row of d = dv * VEC features
// in STEPS steps; wider rows loop.
template <int VEC, class Launch>
void by_lanes(int d, Launch&& launch) {
  const int dv = d / VEC;
  if (dv <= 2)
    launch(Int<2>{}, Int<1>{}, Int<VEC>{});
  else if (dv <= 4)
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

template <class T, class Launch>
void by_width(int d, int vec, Launch&& launch) {
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) return by_lanes<8>(d, launch);
  }
  if (vec == 4)
    by_lanes<4>(d, launch);
  else if (vec == 2)
    by_lanes<2>(d, launch);
  else
    by_lanes<1>(d, launch);
}

// out[split_rows[i]] (+)= sum of partials [split_ptr[i], split_ptr[i+1]) in order,
// in f32, rounded to T once.
template <class T>
__global__ void __launch_bounds__(kWarps * 32)
reduce_partials_kernel(const int* __restrict__ split_rows,
                       const int* __restrict__ split_ptr,
                       const float* __restrict__ partial, T* __restrict__ out,
                       int n_split, int d, int accumulate) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_split) return;
  const int p0 = split_ptr[i], p1 = split_ptr[i + 1];
  T* orow = out + (int64_t)split_rows[i] * d;
  for (int f = lane; f < d; f += 32) {
    float sum = 0.f;
    for (int p = p0; p < p1; ++p) sum += partial[(int64_t)p * d + f];
    orow[f] = from_f32<T>(accumulate ? to_f32(orow[f]) + sum : sum);
  }
}

// The whole launch of kernel 2 or 3 for rows of T: the load width checked,
// the items launched by `kernel(Int<G>, Int<STEPS>, Int<VEC>)`, then the
// partials of the chunked rows added in order.
template <class T, class Kernel>
cudaError_t run(const Args& a, int vec, const void* split_rows, const void* split_ptr,
                int n_split, Kernel&& kernel) {
  if (!vec_fits<T>(a, vec)) return cudaErrorInvalidValue;
  if (a.n_items > 0) {
    by_width<T>(a.d, vec, kernel);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_split > 0) {
    reduce_partials_kernel<T><<<(n_split + kWarps - 1) / kWarps, kWarps * 32, 0, a.stream>>>(
        static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr), a.partial,
        static_cast<T*>(a.out), n_split, a.d, a.accumulate);
  }
  return cudaGetLastError();
}

}  // namespace spmm
