// Kernel 2: gather SpMM over the rows of a CSR, walked as a work list.
//
//   out[i, f] = (accumulate ? out[i, f] : 0) + sum_{e in row i} coef[e] * h[cols[e], f]
//
// Replaces the residual aggregation of the JAX package, which is XLA rather
// than Pallas there: _segment_apply and, above 49,152 nodes, _blocked2d_apply
// over the flat bucketed piece layout (cuda_gcn_tpu/ops/graphsum.py:42,136).
// The piece layout worked around TPU gather and segment-sum costs; on the card
// the residual is plain CSR. The same kernel is the layer-0 product X * W of
// sparse features (ops/matmul.py), with W as the gathered operand.
//
// Bound on the H100: bytes. Each edge reads 8 bytes of index and value and one
// gathered row of h; the least traffic is every input read once and out
// written once, and the random row gathers sit far above that floor. So the
// design is about keeping many row gathers in flight on every SM and wasting
// no lane:
//
// * The host cuts the rows into work items (ops/ell.py work_list): a row, or a
//   chunk of at most 256 edges of a longer row (the reddit residual has a row
//   of 37,181 edges at a mean of 19), longest first. One warp takes one item
//   and 8 warps make a CTA, so a CTA lasts as long as 8 similar items and no
//   warp scans for hubs. The chunks of a long row write partial sums that a
//   second kernel adds in chunk order (spmm_common.cuh).
// * Lanes split over (slot, feature) by d (spmm_common.cuh slot_sum): at d = 16
//   a row of h is 4 lanes of 16 bytes and 8 edges are gathered side by side;
//   at d = 82 it is 41 lanes' 8-byte loads in two steps; an odd d falls back
//   to 4-byte loads.
// * Occupancy before depth: one gather in flight per slot group and 32
//   registers a thread, so that 64 warps fit an SM.
// * The accumulate read of out is fused into the one store of each row. In
//   accumulate mode a row of no edges has nothing to add, so the host launches
//   only the items that have edges (they come first in the list); without
//   accumulate an empty row's item writes zeros.
//
// Every output row has one writer and a fixed summation order: no atomics,
// the same bits on every run (index_add_ on the card is not).

#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_common.cuh"

namespace {

using spmm::kWarps;

// Row gathers in flight per slot group, and CTAs per SM asked of the compiler
// (8 of them leave 32 registers a thread). On the H100 at the reddit shapes 64
// warps per SM with one gather each beat 24 warps with 8, and two or four in
// flight gain nothing over one. An item is a chain of three dependent loads
// (item, slots, rows), and more warps hide it better than deeper batches do.
constexpr int kIlp = 1;
constexpr int kCtasPerSm = 8;

template <int G, int STEPS, int VEC>
__global__ void __launch_bounds__(kWarps * 32, kCtasPerSm)
csr_spmm_kernel(const int* __restrict__ work_beg, const int* __restrict__ work_len,
                const int* __restrict__ work_dst, const int* __restrict__ cols,
                const float* __restrict__ coef, const float* __restrict__ h,
                float* __restrict__ out, float* __restrict__ partial, int n_items, int d,
                int accumulate) {
  constexpr int W = STEPS * VEC;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;  // the whole warp leaves together
  const int beg = work_beg[item], len = work_len[item], dst = work_dst[item];
  float* orow = dst >= 0 ? out + (int64_t)dst * d : partial + (int64_t)(-dst - 1) * d;
  const bool add = accumulate && dst >= 0;  // a chunk's partial starts from zero
  for (int f0 = 0; f0 < d; f0 += G * W) {
    float acc[W];
    // at most G in flight: a batch of 32 slots is whole rounds of 32 / G * ILP
    spmm::slot_sum<G, STEPS, VEC, (kIlp < G ? kIlp : G)>(cols, coef, h, d, f0, beg, len, lane,
                                                         acc);
    if (lane < G) {
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int f = f0 + (s * G + lane) * VEC;
        if (f < d) {
          if (add) {
            float old[VEC];
            spmm::load_vec<VEC>(orow + f, old);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[s * VEC + v] += old[v];
          }
          spmm::store_vec<VEC>(orow + f, &acc[s * VEC]);
        }
      }
    }
  }
}

struct Args {
  const int *beg, *len, *dst, *cols;
  const float *coef, *h;
  float *out, *partial;
  int n_items, d, accumulate;
  cudaStream_t stream;
};

template <int G, int STEPS, int VEC>
void launch(const Args& a) {
  const int blocks = (a.n_items + kWarps - 1) / kWarps;
  csr_spmm_kernel<G, STEPS, VEC><<<blocks, kWarps * 32, 0, a.stream>>>(
      a.beg, a.len, a.dst, a.cols, a.coef, a.h, a.out, a.partial, a.n_items, a.d,
      a.accumulate);
}

// G lanes of VEC features cover a row of d = dv * VEC features in STEPS steps;
// wider rows loop.
template <int VEC>
void launch_width(const Args& a) {
  const int dv = a.d / VEC;
  if (dv <= 4)
    launch<4, 1, VEC>(a);
  else if (dv <= 8)
    launch<8, 1, VEC>(a);
  else if (dv <= 16)
    launch<16, 1, VEC>(a);
  else if (dv <= 32)
    launch<32, 1, VEC>(a);
  else if (dv <= 64)
    launch<32, 2, VEC>(a);
  else
    launch<32, 3, VEC>(a);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" int csr_spmm(const void* work_beg, const void* work_len, const void* work_dst,
                        int n_items, const void* split_rows, const void* split_ptr,
                        int n_split, const void* cols, const void* coef, const void* h,
                        void* out, void* partial, int d, int accumulate, void* stream) {
  Args a{static_cast<const int*>(work_beg), static_cast<const int*>(work_len),
         static_cast<const int*>(work_dst), static_cast<const int*>(cols),
         static_cast<const float*>(coef),   static_cast<const float*>(h),
         static_cast<float*>(out),          static_cast<float*>(partial),
         n_items, d, accumulate, static_cast<cudaStream_t>(stream)};
  if (n_items > 0) {
    // the widest load that d and the three row bases allow
    auto fits = [&](int vec) {
      return d % vec == 0 && aligned(h, 4 * vec) && aligned(out, 4 * vec) &&
             aligned(partial, 4 * vec);
    };
    if (fits(4))
      launch_width<4>(a);
    else if (fits(2))
      launch_width<2>(a);
    else
      launch_width<1>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(spmm::reduce_partials(
      static_cast<const int*>(split_rows), static_cast<const int*>(split_ptr), a.partial,
      a.out, n_split, d, accumulate, a.stream));
}
