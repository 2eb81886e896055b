// The GAT's multi-head attention over the ELL plan (ops/attention.py), in f32:
//
//   e[i, j, k] = LeakyReLU(sl[i, k] + sr[j, k])            for the slots j of row i
//   a[i, j, k] = exp(e[i, j, k] - m[i, k]) / den[i, k]       the row softmax
//   out[i, k, :] = sum_j a[i, j, k] * keep[s, k] / q * z[j, k, :]
//
// with z [N, K * F'] (the heads side by side), sl and sr [N, K] (z's scores
// against a_l and a_r, made by ATen), and keep the attention dropout, drawn
// here. Replaces no TPU kernel: the JAX package has no attention model.
//
// F' here is the floats a head takes in a row. The GAT pads a head whose
// features are no multiple of 4 with zeros to 4 * ceil(F' / 4) floats
// (ops/attention.py ``head_stride``), so that its rows lie 16 bytes apart and
// load as float4: at 1 x 41, 2 float4 loads a lane where there were 8 scalar
// ones. A zero feature adds exact zeros to every sum, so the kernels take the
// padding as features, and out's and dz's padding comes out 0 (g's padding is
// 0 too: the gradient of a slice).
//
// Three launches, each over a work list of ops/ell.py (an item is a row's
// slots, or a chunk of at most 256 slots of a longer row, whose partial
// results a second kernel of the same launch combines in chunk order):
//
//   gat_forward  over Â's plan: the scores, the softmax and the weighted sum
//                in one pass (an online softmax: a running max and sum a head,
//                rescaled when the max rises), and the row's max and sum
//                [N, K, 2] for the backward. A chunked row's partials hold
//                their own max; the second kernel rescales them to the row's.
//   gat_rows     over Â's plan, for each row i from the gradient g of out:
//                da[i, j, k] = keep / q * <g[i, k, :], z[j, k, :]>, and the
//                sums A = sum_j a da, B = sum_j a da l', C = sum_j a l' (l' the
//                LeakyReLU's slope at the score); then the score gradient of
//                the row's own side dsl[i, k] = sum_j a (da - A) l' = B - A C,
//                and node [N, K, 4] = (sl, m, 1 / den, A) for the next launch
//                (a weight is exp(e - m) times the reciprocal in both passes).
//   gat_cols     over Âᵀ's plan (Â's own for a symmetric pattern), for each
//                row j: dz[j, k, :] = sum_i a[i, j, k] keep / q g[i, k, :] and
//                dsr[j, k] = sum_i a (da - A[i]) l', gathering g[i] and
//                node[i] (one 16-byte load a head) by the slot's column and
//                drawing the mask at the forward slot of the same edge, which
//                the reverse-edge map gives (ops/ell.py ``reverse_slots``).
//
// Nothing of [S, K] is stored: a weight is recomputed from the row's max and
// sum wherever it is needed (at synth-reddit's 21M slots and 8 heads an [S, K]
// f32 tensor is 671 MB). Every output row has one writer and a fixed order
// of additions: no atomics, the same bits on every run.
//
// The mask: keep[s, k] is word k % 4 of the Philox4x32-10 call (Salmon et al.,
// SC'11) at counter s * ceil(K / 4) + k / 4 (two words), then the offset
// (two words), under the key; kept where the word is below q * 2^32 (rounded).
// Key and offset are two int64 that the caller draws on the device from the
// job's generator (read here from device memory: a replayed CUDA graph draws a
// fresh mask, and the host reads nothing); ops/attention.attention_keep
// restates it.
//
// Lanes (kernels.gat_layout): a head's F' features are P = F' / VEC pieces of
// VEC floats (VEC 4, 2 or 1, the widest that F' and the bases allow), held by
// L2 lanes (a power of two), STEPS pieces a lane (a power of two, at most 8
// floats a lane; in the backward passes up to 4 float4, which halves their
// butterflies' lanes and doubles the slots side by side). The K heads of a
// slot take G = K * L2 lanes (rounded up to a
// power of two, at most 32), and 32 / G slots are taken side by side; each
// lane holds one head. The host takes the least L2 that fits, so as many slots
// as it can side by side: at 8 heads of 8, a lane a head and 4 slots; at one
// head of 41 padded to 44, 8 lanes of 2 float4 (the last 5 pieces idle) and 4
// slots (unpadded, 8 lanes of 8 scalar loads, the last 23 idle). A head's dot
// products are added by an xor butterfly over its L2 lanes, and the slot
// groups are merged by one over the offsets G to 16.
//
// The mask is drawn once a slot: lane i draws the bits of slot e0 + i of a
// batch of 32 (ceil(K / 4) Philox calls), and the lanes that take the slot
// read them by a shuffle.
//
// Bound on the H100: bytes, and within that the gathers of z or g (a row of
// K * F' floats a slot, 256 bytes at 8 x 8), as for kernel 3 (spmm_common.cuh).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // work items (warps) a CTA

// CTAs an SM asked of the compiler for each item kernel, a register cap of
// 65536 / (256 * n) a thread: the kernels wait on row gathers, and more
// resident warps hide them, until the cap spills. Measured on the H100 at
// synth-reddit's 8 x 8 and 1 x 41 (ms, n = 1 / 3 / 4 / 5): forward 1.394,
// 1.373 / 1.383, 1.365 / 1.624, 1.290 / 1.785, 1.580; rows 1.995, 2.579 /
// 1.973, 1.790 / 1.738, 1.703 / 2.210, 1.952; columns 1.966, 2.403 / 1.955,
// 1.763 / 1.995, 1.771 / 2.606, 2.169 (every variant's results equal bit for
// bit).
constexpr int kForwardCtas = 3;
constexpr int kRowsCtas = 4;
constexpr int kColsCtas = 3;
// A lane of 16 floats (the backward passes' 4 float4 at 1 x 41 padded to 44)
// is capped at 3 CTAs an SM (85 registers; rows and columns spill a little):
// rows 1.306 ms, columns 1.588 at 3; 1.607, 1.697 at 2 (H100, synth-reddit).
constexpr int kWideCtas = 3;
template <int W>
constexpr int ctas(int narrow) { return W > 8 ? kWideCtas : narrow; }

// Philox4x32-10: four 32-bit uniforms of counter `c` under `key`.
__device__ __forceinline__ uint4 philox(uint2 key, uint4 c) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned long long p0 = 0xD2511F53ull * c.x;
    const unsigned long long p1 = 0xCD9E8D57ull * c.z;
    c = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ c.y ^ key.x, static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ c.w ^ key.y, static_cast<uint32_t>(p0));
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return c;
}

// The attention dropout of a launch; `on` false keeps everything.
struct Mask {
  bool on;
  uint2 key;
  uint32_t off_lo, off_hi;
  uint32_t thresh;
  int calls;  // Philox calls a slot: ceil(K / 4)

  // Bit k set where head k of forward slot `slot` keeps its weight (every
  // bit without dropout): the ceil(K / 4) Philox calls of the slot.
  __device__ __forceinline__ uint32_t bits(long long slot, int heads) const {
    if (!on) return kFull;
    uint32_t b = 0u;
    for (int c = 0; c < calls; ++c) {
      const unsigned long long ctr = static_cast<unsigned long long>(slot) * calls + c;
      const uint4 u = philox(key, make_uint4(static_cast<uint32_t>(ctr),
                                             static_cast<uint32_t>(ctr >> 32), off_lo, off_hi));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * c + i < heads && w[i] < thresh) b |= 1u << (4 * c + i);
    }
    return b;
  }
};

// What every item kernel is given.
struct Common {
  const int *beg, *len, *dst, *partial_row, *cols;
  const long long* seeds;  // null: no dropout
  int n_items, heads, fh, l2, g;
  float slope, inv_q;
  uint32_t thresh;
};

__device__ __forceinline__ Mask mask_of(const Common& c) {
  Mask m{c.seeds != nullptr, make_uint2(0u, 0u), 0u, 0u, c.thresh, (c.heads + 3) / 4};
  if (m.on) {
    const unsigned long long seed = static_cast<unsigned long long>(__ldg(c.seeds));
    const unsigned long long off = static_cast<unsigned long long>(__ldg(c.seeds + 1));
    m.key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
    m.off_lo = static_cast<uint32_t>(off);
    m.off_hi = static_cast<uint32_t>(off >> 32);
  }
  return m;
}

// Where a lane sits: its slot group, its head and its piece within the head.
struct Lane {
  int lane, grp, head, piece, per;  // per: slots side by side
  bool on;                          // the lane holds features of a head
};

__device__ __forceinline__ Lane lane_of(const Common& c) {
  Lane l;
  l.lane = threadIdx.x & 31;
  l.per = 32 / c.g;
  l.grp = l.lane / c.g;
  const int sub = l.lane % c.g;
  l.head = sub / c.l2;
  l.piece = sub % c.l2;
  l.on = l.head < c.heads;
  return l;
}

// The lane's features of a row of K * F' floats: STEPS pieces of VEC, zero
// where a piece lies past the head's F' (or the lane holds no head).
template <int VEC, int STEPS>
__device__ __forceinline__ void load_row(const float* __restrict__ row, const Lane& l,
                                         const Common& c, float* v) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int f = (s * c.l2 + l.piece) * VEC;
    const float* p = row + l.head * c.fh + f;
    if (l.on && f < c.fh) {
      if constexpr (VEC == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        v[s * 4] = t.x, v[s * 4 + 1] = t.y, v[s * 4 + 2] = t.z, v[s * 4 + 3] = t.w;
      } else if constexpr (VEC == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p));
        v[s * 2] = t.x, v[s * 2 + 1] = t.y;
      } else {
        v[s] = __ldg(p);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[s * VEC + i] = 0.f;
    }
  }
}

// row[...] <- v * scale, the lane's pieces that lie within the head.
template <int VEC, int STEPS>
__device__ __forceinline__ void store_row(float* __restrict__ row, const Lane& l,
                                          const Common& c, const float* v, float scale) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int f = (s * c.l2 + l.piece) * VEC;
    float* p = row + l.head * c.fh + f;
    if (l.on && f < c.fh) {
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[s * 4] * scale, v[s * 4 + 1] * scale,
                                                    v[s * 4 + 2] * scale, v[s * 4 + 3] * scale);
      } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[s * 2] * scale, v[s * 2 + 1] * scale);
      } else {
        *p = v[s] * scale;
      }
    }
  }
}

__device__ __forceinline__ float leaky(float e, float slope) { return e > 0.f ? e : e * slope; }

// The head's sum of the lanes' `x` (an xor butterfly over its L2 lanes).
__device__ __forceinline__ float head_sum(float x, int l2) {
  for (int off = 1; off < l2; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The row of an item: its output row, or the row whose chunk it is.
__device__ __forceinline__ int row_of(const Common& c, int dst) {
  return dst >= 0 ? dst : c.partial_row[-dst - 1];
}

struct FwdArgs {
  Common c;
  const float *z, *sl, *sr;
  float *out, *stats;  // stats null: not kept (the evaluation forward)
  float *pacc, *pm, *pden;
};

template <int VEC, int STEPS>
__global__ void __launch_bounds__(kWarps * 32, ctas<VEC * STEPS>(kForwardCtas))
    gat_forward_kernel(FwdArgs a) {
  constexpr int W = VEC * STEPS;
  const Common& c = a.c;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= c.n_items) return;  // the whole warp leaves together
  const Lane l = lane_of(c);
  const Mask mask = mask_of(c);
  const int d = c.heads * c.fh;
  const int beg = c.beg[item], len = c.len[item], dst = c.dst[item];
  const int row = row_of(c, dst);
  const float sl = l.on ? __ldg(a.sl + static_cast<int64_t>(row) * c.heads + l.head) : 0.f;
  float m = -INFINITY, den = 0.f, acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  for (int e0 = 0; e0 < len; e0 += 32) {
    int col_l = 0;
    uint32_t keep_l = 0u;
    if (e0 + l.lane < len) {
      col_l = __ldcs(c.cols + beg + e0 + l.lane);
      keep_l = mask.bits(static_cast<long long>(beg) + e0 + l.lane, c.heads);
    }
    const int mm = min(32, len - e0);
    for (int k = 0; k < mm; k += l.per) {
      const int j = k + l.grp;  // below 32: k < mm <= 32 and k + per <= 32
      const int col = __shfl_sync(kFull, col_l, j);
      const uint32_t keep = __shfl_sync(kFull, keep_l, j);
      if (j < mm && l.on) {
        const float e = leaky(sl + __ldg(a.sr + static_cast<int64_t>(col) * c.heads + l.head),
                              c.slope);
        float zv[W];
        load_row<VEC, STEPS>(a.z + static_cast<int64_t>(col) * d, l, c, zv);
        // one exp a slot: the larger of (e, m) is the new max
        const float t = expf(-fabsf(e - m));
        const bool up = e > m;
        const float s = up ? t : 1.f, p = up ? 1.f : t;
        m = up ? e : m;
        den = den * s + p;
        const float pk = (keep >> l.head) & 1u ? p : 0.f;
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = fmaf(pk, zv[i], acc[i] * s);
      }
    }
  }
  for (int off = c.g; off < 32; off <<= 1) {  // the slot groups, merged
    const float m2 = __shfl_xor_sync(kFull, m, off), d2 = __shfl_xor_sync(kFull, den, off);
    float a2[W];
#pragma unroll
    for (int i = 0; i < W; ++i) a2[i] = __shfl_xor_sync(kFull, acc[i], off);
    const float mx = fmaxf(m, m2);
    if (mx != -INFINITY) {
      const float s1 = expf(m - mx), s2 = expf(m2 - mx);
      den = den * s1 + d2 * s2;
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = acc[i] * s1 + a2[i] * s2;
      m = mx;
    }
  }
  if (l.grp != 0 || !l.on) return;
  if (dst >= 0) {
    store_row<VEC, STEPS>(a.out + static_cast<int64_t>(row) * d, l, c, acc,
                          den > 0.f ? c.inv_q / den : 0.f);
    if (a.stats != nullptr && l.piece == 0) {
      float* st = a.stats + (static_cast<int64_t>(row) * c.heads + l.head) * 2;
      st[0] = m;
      st[1] = den;
    }
  } else {
    const int p = -dst - 1;
    store_row<VEC, STEPS>(a.pacc + static_cast<int64_t>(p) * d, l, c, acc, 1.f);
    if (l.piece == 0) {
      a.pm[static_cast<int64_t>(p) * c.heads + l.head] = m;
      a.pden[static_cast<int64_t>(p) * c.heads + l.head] = den;
    }
  }
}

struct Reduce {
  const int *split_rows, *split_ptr;
  int n_split, heads, fh;
  float inv_q;
};

// A chunked row's partials rescaled to the row's max and added in chunk
// order: its output row and its max and sum. A warp a row.
__global__ void __launch_bounds__(kWarps * 32)
gat_forward_reduce_kernel(Reduce r, const float* __restrict__ pacc, const float* __restrict__ pm,
                          const float* __restrict__ pden, float* __restrict__ out,
                          float* __restrict__ stats) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= r.n_split) return;
  const int p0 = r.split_ptr[i], p1 = r.split_ptr[i + 1], row = r.split_rows[i];
  const int d = r.heads * r.fh;
  for (int f = lane; f < d + r.heads; f += 32) {
    const int head = f < d ? f / r.fh : f - d;
    float m = -INFINITY;
    for (int p = p0; p < p1; ++p) m = fmaxf(m, pm[static_cast<int64_t>(p) * r.heads + head]);
    float den = 0.f, acc = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float pmp = pm[static_cast<int64_t>(p) * r.heads + head];
      const float s = pmp == -INFINITY ? 0.f : expf(pmp - m);
      den += pden[static_cast<int64_t>(p) * r.heads + head] * s;
      if (f < d) acc += pacc[static_cast<int64_t>(p) * d + f] * s;
    }
    if (f < d) {
      out[static_cast<int64_t>(row) * d + f] = acc * (den > 0.f ? r.inv_q / den : 0.f);
    } else if (stats != nullptr) {
      stats[(static_cast<int64_t>(row) * r.heads + head) * 2] = m;
      stats[(static_cast<int64_t>(row) * r.heads + head) * 2 + 1] = den;
    }
  }
}

struct RowArgs {
  Common c;
  const float *g, *z, *sl, *sr, *stats;
  float *node, *dsl;
  float* pabc;  // [n_partials, K, 3]: A, B, C of each chunk
};

template <int VEC, int STEPS>
__global__ void __launch_bounds__(kWarps * 32, ctas<VEC * STEPS>(kRowsCtas))
    gat_rows_kernel(RowArgs a) {
  constexpr int W = VEC * STEPS;
  const Common& c = a.c;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= c.n_items) return;
  const Lane l = lane_of(c);
  const Mask mask = mask_of(c);
  const int d = c.heads * c.fh;
  const int beg = c.beg[item], len = c.len[item], dst = c.dst[item];
  const int row = row_of(c, dst);
  const int64_t rh = static_cast<int64_t>(row) * c.heads + l.head;
  float gv[W];
  load_row<VEC, STEPS>(a.g + static_cast<int64_t>(row) * d, l, c, gv);
  const float sl = l.on ? __ldg(a.sl + rh) : 0.f;
  const float m = l.on ? __ldg(a.stats + 2 * rh) : 0.f;
  const float rden = l.on ? 1.f / __ldg(a.stats + 2 * rh + 1) : 0.f;
  float sa = 0.f, sb = 0.f, sc = 0.f;
  for (int e0 = 0; e0 < len; e0 += 32) {
    int col_l = 0;
    uint32_t keep_l = 0u;
    if (e0 + l.lane < len) {
      col_l = __ldcs(c.cols + beg + e0 + l.lane);
      keep_l = mask.bits(static_cast<long long>(beg) + e0 + l.lane, c.heads);
    }
    const int mm = min(32, len - e0);
    for (int k = 0; k < mm; k += l.per) {
      const int j = k + l.grp;
      const int col = __shfl_sync(kFull, col_l, j);
      const uint32_t keep = __shfl_sync(kFull, keep_l, j);
      const bool valid = j < mm && l.on;
      float zv[W];
      if (valid) {
        load_row<VEC, STEPS>(a.z + static_cast<int64_t>(col) * d, l, c, zv);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) zv[i] = 0.f;
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) dot = fmaf(gv[i], zv[i], dot);
      dot = head_sum(dot, c.l2);
      if (valid) {
        const float ep = sl + __ldg(a.sr + static_cast<int64_t>(col) * c.heads + l.head);
        const float lam = ep > 0.f ? 1.f : c.slope;
        const float alpha = expf(leaky(ep, c.slope) - m) * rden;
        const float da = (keep >> l.head) & 1u ? dot * c.inv_q : 0.f;
        const float ad = alpha * da;
        sa += ad;
        sb = fmaf(ad, lam, sb);
        sc = fmaf(alpha, lam, sc);
      }
    }
  }
  for (int off = c.g; off < 32; off <<= 1) {
    sa += __shfl_xor_sync(kFull, sa, off);
    sb += __shfl_xor_sync(kFull, sb, off);
    sc += __shfl_xor_sync(kFull, sc, off);
  }
  if (l.grp != 0 || !l.on || l.piece != 0) return;
  if (dst >= 0) {
    *reinterpret_cast<float4*>(a.node + 4 * rh) = make_float4(sl, m, rden, sa);
    a.dsl[rh] = sb - sa * sc;
  } else {
    float* abc = a.pabc + (static_cast<int64_t>(-dst - 1) * c.heads + l.head) * 3;
    abc[0] = sa;
    abc[1] = sb;
    abc[2] = sc;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
gat_rows_reduce_kernel(Reduce r, const float* __restrict__ pabc, const float* __restrict__ sl,
                       const float* __restrict__ stats, float* __restrict__ node,
                       float* __restrict__ dsl) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= r.n_split) return;
  const int p0 = r.split_ptr[i], p1 = r.split_ptr[i + 1], row = r.split_rows[i];
  for (int head = lane; head < r.heads; head += 32) {
    float sa = 0.f, sb = 0.f, sc = 0.f;
    for (int p = p0; p < p1; ++p) {
      const float* abc = pabc + (static_cast<int64_t>(p) * r.heads + head) * 3;
      sa += abc[0];
      sb += abc[1];
      sc += abc[2];
    }
    const int64_t rh = static_cast<int64_t>(row) * r.heads + head;
    *reinterpret_cast<float4*>(node + 4 * rh) = make_float4(sl[rh], stats[2 * rh],
                                                            1.f / stats[2 * rh + 1], sa);
    dsl[rh] = sb - sa * sc;
  }
}

struct ColArgs {
  Common c;  // over Âᵀ's plan
  const int* rev;
  const float *g, *z, *sr, *node;
  float *dz, *dsr;
  float *pacc, *pds;
};

template <int VEC, int STEPS>
__global__ void __launch_bounds__(kWarps * 32, ctas<VEC * STEPS>(kColsCtas))
    gat_cols_kernel(ColArgs a) {
  constexpr int W = VEC * STEPS;
  const Common& c = a.c;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= c.n_items) return;
  const Lane l = lane_of(c);
  const Mask mask = mask_of(c);
  const int d = c.heads * c.fh;
  const int beg = c.beg[item], len = c.len[item], dst = c.dst[item];
  const int row = row_of(c, dst);
  float zv[W];
  load_row<VEC, STEPS>(a.z + static_cast<int64_t>(row) * d, l, c, zv);
  const float sr = l.on ? __ldg(a.sr + static_cast<int64_t>(row) * c.heads + l.head) : 0.f;
  float acc[W], ds = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = 0.f;
  for (int e0 = 0; e0 < len; e0 += 32) {
    int col_l = 0;
    uint32_t keep_l = 0u;
    if (e0 + l.lane < len) {  // the mask of the forward slot of the same edge
      col_l = __ldcs(c.cols + beg + e0 + l.lane);
      keep_l = mask.bits(__ldcs(a.rev + beg + e0 + l.lane), c.heads);
    }
    const int mm = min(32, len - e0);
    for (int k = 0; k < mm; k += l.per) {
      const int j = k + l.grp;
      const int col = __shfl_sync(kFull, col_l, j);
      const uint32_t keep_j = __shfl_sync(kFull, keep_l, j);
      const bool valid = j < mm && l.on;
      float gv[W];
      float4 nd = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        load_row<VEC, STEPS>(a.g + static_cast<int64_t>(col) * d, l, c, gv);
        nd = __ldg(reinterpret_cast<const float4*>(
            a.node + 4 * (static_cast<int64_t>(col) * c.heads + l.head)));
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) gv[i] = 0.f;
      }
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) dot = fmaf(gv[i], zv[i], dot);
      dot = head_sum(dot, c.l2);
      if (valid) {
        const float ep = nd.x + sr;
        const float lam = ep > 0.f ? 1.f : c.slope;
        const float alpha = expf(leaky(ep, c.slope) - nd.y) * nd.z;
        const bool keep = (keep_j >> l.head) & 1u;
        const float da = keep ? dot * c.inv_q : 0.f;
        ds = fmaf(alpha * (da - nd.w), lam, ds);
        const float w = keep ? alpha * c.inv_q : 0.f;
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = fmaf(w, gv[i], acc[i]);
      }
    }
  }
  for (int off = c.g; off < 32; off <<= 1) {
    ds += __shfl_xor_sync(kFull, ds, off);
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
  if (l.grp != 0 || !l.on) return;
  if (dst >= 0) {
    store_row<VEC, STEPS>(a.dz + static_cast<int64_t>(row) * d, l, c, acc, 1.f);
    if (l.piece == 0) a.dsr[static_cast<int64_t>(row) * c.heads + l.head] = ds;
  } else {
    const int p = -dst - 1;
    store_row<VEC, STEPS>(a.pacc + static_cast<int64_t>(p) * d, l, c, acc, 1.f);
    if (l.piece == 0) a.pds[static_cast<int64_t>(p) * c.heads + l.head] = ds;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
gat_cols_reduce_kernel(Reduce r, const float* __restrict__ pacc, const float* __restrict__ pds,
                       float* __restrict__ dz, float* __restrict__ dsr) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= r.n_split) return;
  const int p0 = r.split_ptr[i], p1 = r.split_ptr[i + 1], row = r.split_rows[i];
  const int d = r.heads * r.fh;
  for (int f = lane; f < d + r.heads; f += 32) {
    float sum = 0.f;
    for (int p = p0; p < p1; ++p)
      sum += f < d ? pacc[static_cast<int64_t>(p) * d + f]
                   : pds[static_cast<int64_t>(p) * r.heads + f - d];
    if (f < d)
      dz[static_cast<int64_t>(row) * d + f] = sum;
    else
      dsr[static_cast<int64_t>(row) * r.heads + f - d] = sum;
  }
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls launch(Int<VEC>, Int<STEPS>) for the layouts built (VEC * STEPS at
// most 8 floats a lane, and 4 float4 a lane); another is refused.
template <class Launch>
cudaError_t by_layout(int vec, int steps, Launch&& launch) {
  if (vec == 4) {
    if (steps == 1) return launch(Int<4>{}, Int<1>{});
    if (steps == 2) return launch(Int<4>{}, Int<2>{});
    if (steps == 4) return launch(Int<4>{}, Int<4>{});
  } else if (vec == 2) {
    if (steps == 1) return launch(Int<2>{}, Int<1>{});
    if (steps == 2) return launch(Int<2>{}, Int<2>{});
    if (steps == 4) return launch(Int<2>{}, Int<4>{});
  } else if (vec == 1) {
    if (steps == 1) return launch(Int<1>{}, Int<1>{});
    if (steps == 2) return launch(Int<1>{}, Int<2>{});
    if (steps == 4) return launch(Int<1>{}, Int<4>{});
    if (steps == 8) return launch(Int<1>{}, Int<8>{});
  }
  return cudaErrorInvalidValue;
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// The lane split (kernels.gat_layout) holds together: L2 lanes a head, G a
// slot, the heads' pieces covered.
bool layout_ok(int heads, int fh, int vec, int l2, int g, int steps) {
  return heads > 0 && heads <= 32 && fh > 0 && pow2(l2) && pow2(g) && g <= 32 &&
         heads * l2 <= g && fh % vec == 0 && steps * l2 * vec >= fh;
}

Common common(const void* beg, const void* len, const void* dst, int n_items,
              const void* partial_row, const void* cols, const void* seeds, int heads, int fh,
              int l2, int g, float slope, float inv_q, unsigned thresh) {
  return Common{static_cast<const int*>(beg), static_cast<const int*>(len),
                static_cast<const int*>(dst), static_cast<const int*>(partial_row),
                static_cast<const int*>(cols), static_cast<const long long*>(seeds),
                n_items, heads, fh, l2, g, slope, inv_q, thresh};
}

int blocks(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

// out [n, K * F'] (and the row's max and sum [n, K, 2] into `stats`, unless
// null); `seeds` null: no dropout. `partial` holds n_partials rows of
// K * F' + 2 K floats.
extern "C" int gat_forward(const void* beg, const void* len, const void* dst, int n_items,
                           const void* partial_row, const void* split_rows,
                           const void* split_ptr, int n_split, const void* cols,
                           const void* z, const void* sl, const void* sr, const void* seeds,
                           void* out, void* stats, void* partial, int n_partials, int heads,
                           int fh, int vec, int l2, int g, int steps, float slope, float inv_q,
                           unsigned thresh, void* stream) {
  if (!layout_ok(heads, fh, vec, l2, g, steps)) return cudaErrorInvalidValue;
  const int d = heads * fh;
  float* pacc = static_cast<float*>(partial);
  float* pm = pacc + static_cast<int64_t>(n_partials) * d;
  float* pden = pm + static_cast<int64_t>(n_partials) * heads;
  const FwdArgs a{common(beg, len, dst, n_items, partial_row, cols, seeds, heads, fh, l2, g,
                         slope, inv_q, thresh),
                  static_cast<const float*>(z), static_cast<const float*>(sl),
                  static_cast<const float*>(sr), static_cast<float*>(out),
                  static_cast<float*>(stats), pacc, pm, pden};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items > 0) {
    const cudaError_t err = by_layout(vec, steps, [&](auto v, auto st) {
      gat_forward_kernel<decltype(v)::value, decltype(st)::value>
          <<<blocks(n_items), kWarps * 32, 0, s>>>(a);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  if (n_split > 0) {
    const Reduce r{static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr),
                   n_split, heads, fh, inv_q};
    gat_forward_reduce_kernel<<<blocks(n_split), kWarps * 32, 0, s>>>(
        r, pacc, pm, pden, static_cast<float*>(out), static_cast<float*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

// From g, the gradient of out: node [n, K, 4] = (sl, m, den, A) and dsl
// [n, K]. `partial` holds n_partials rows of 3 K floats.
extern "C" int gat_rows(const void* beg, const void* len, const void* dst, int n_items,
                        const void* partial_row, const void* split_rows, const void* split_ptr,
                        int n_split, const void* cols, const void* g_, const void* z,
                        const void* sl, const void* sr, const void* stats, const void* seeds,
                        void* node, void* dsl, void* partial, int heads, int fh, int vec,
                        int l2, int g, int steps, float slope, float inv_q, unsigned thresh,
                        void* stream) {
  if (!layout_ok(heads, fh, vec, l2, g, steps)) return cudaErrorInvalidValue;
  const RowArgs a{common(beg, len, dst, n_items, partial_row, cols, seeds, heads, fh, l2, g,
                         slope, inv_q, thresh),
                  static_cast<const float*>(g_), static_cast<const float*>(z),
                  static_cast<const float*>(sl), static_cast<const float*>(sr),
                  static_cast<const float*>(stats), static_cast<float*>(node),
                  static_cast<float*>(dsl), static_cast<float*>(partial)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items > 0) {
    const cudaError_t err = by_layout(vec, steps, [&](auto v, auto st) {
      gat_rows_kernel<decltype(v)::value, decltype(st)::value>
          <<<blocks(n_items), kWarps * 32, 0, s>>>(a);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  if (n_split > 0) {
    const Reduce r{static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr),
                   n_split, heads, fh, inv_q};
    gat_rows_reduce_kernel<<<blocks(n_split), kWarps * 32, 0, s>>>(
        r, static_cast<const float*>(partial), static_cast<const float*>(sl),
        static_cast<const float*>(stats), static_cast<float*>(node), static_cast<float*>(dsl));
  }
  return static_cast<int>(cudaGetLastError());
}

// Over Âᵀ's plan (its work list, columns and the reverse map `rev`): dz
// [n, K * F'] and dsr [n, K]. `partial` holds n_partials rows of K * F' + K
// floats.
extern "C" int gat_cols(const void* beg, const void* len, const void* dst, int n_items,
                        const void* partial_row, const void* split_rows, const void* split_ptr,
                        int n_split, const void* cols, const void* rev, const void* g_,
                        const void* z, const void* sr, const void* node, const void* seeds,
                        void* dz, void* dsr, void* partial, int n_partials, int heads, int fh,
                        int vec, int l2, int g, int steps, float slope, float inv_q,
                        unsigned thresh, void* stream) {
  if (!layout_ok(heads, fh, vec, l2, g, steps)) return cudaErrorInvalidValue;
  const int d = heads * fh;
  float* pacc = static_cast<float*>(partial);
  float* pds = pacc + static_cast<int64_t>(n_partials) * d;
  const ColArgs a{common(beg, len, dst, n_items, partial_row, cols, seeds, heads, fh, l2, g,
                         slope, inv_q, thresh),
                  static_cast<const int*>(rev), static_cast<const float*>(g_),
                  static_cast<const float*>(z), static_cast<const float*>(sr),
                  static_cast<const float*>(node), static_cast<float*>(dz),
                  static_cast<float*>(dsr), pacc, pds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items > 0) {
    const cudaError_t err = by_layout(vec, steps, [&](auto v, auto st) {
      gat_cols_kernel<decltype(v)::value, decltype(st)::value>
          <<<blocks(n_items), kWarps * 32, 0, s>>>(a);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
  }
  if (n_split > 0) {
    const Reduce r{static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr),
                   n_split, heads, fh, inv_q};
    gat_cols_reduce_kernel<<<blocks(n_split), kWarps * 32, 0, s>>>(
        r, pacc, pds, static_cast<float*>(dz), static_cast<float*>(dsr));
  }
  return static_cast<int>(cudaGetLastError());
}
