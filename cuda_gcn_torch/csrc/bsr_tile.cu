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
// Two kernels; the launcher (kernels.bsr_tile) chooses by tile type, tile size
// and width, never by a failed build or launch.
//
// A. bsr_mma_kernel: bf16 tiles, tb a multiple of 64 up to 256, d <= 88 (twice
// the 41 classes of reddit, the widest pass of any dataset of the repo). The
// production path.
//
// Bound on the H100: bytes. At the reddit shapes the 2.88 GB of bf16 tiles
// take 0.87-0.90 ms to stream once at any width. The arithmetic fits under
// that only on the tensor cores, which take bf16: an f32 number is exactly the
// sum of three bf16 numbers (24 = 8 + 8 + 8 mantissa bits), a bf16 x bf16
// product is exact in f32, so A*h = A*hi + A*mid + A*lo with f32 accumulators is
// the f32 result up to the order of the additions, in three tensor-core passes
// (0.77 ms at N = 88 at the card's bf16 peak). What the design does about it:
//
// * One CTA owns one whole block row at the whole width N (d rounded up to 16,
//   32, 48 or 88), so every tile crosses device memory once per pass.
//   CTAs start in the order of TilePlan.by_load, most tiles first, so the long
//   rows (93 tiles against a mean of 24 on synth-reddit) do not form the tail.
// * A pre-pass kernel (split_planes_kernel) writes the three bf16 parts of h
//   once per launch as planes [3][N][T*tb], rows past n and columns past d
//   zero: no padding or masking is left in the hot loop. The planes are stored
//   K-major (the tile's column index j contiguous), so that both wgmma operands
//   are read in the layout every Hopper GEMM uses.
// * A ring of stages in dynamic shared memory. A stage is a [tb, 64] slab of
//   the tile (32 KB at tb = 256) and the matching [N, 64] slabs of the three
//   planes; three stages fit at N = 88. One producer thread fills them with TMA
//   tensor loads (128-byte swizzle) that complete on mbarriers: no tile byte
//   passes through registers.
// * tb / 64 consumer warpgroups, each holding 64 rows x N f32 accumulators in
//   registers (N / 2 per thread), run wgmma.mma_async m64nNk16 with both
//   operands from shared memory: 4 k-steps x 3 planes per stage. One group of
//   wgmma stays in flight while the next stage is waited for; a stage is handed
//   back to the producer when the group that read it has retired.
// * Accuracy. The tensor cores round the running f32 sum at every wgmma, so
//   one accumulator across a whole block row drifts with the row's length
//   (synth-reddit4x has rows of 89 tiles on average and 178 at most, where
//   the drift passed the checks' tolerance; PERF.md §6). Each tile's sums
//   therefore go into a second register set with IEEE adds when its last
//   stage retires, and the next tile starts from zero. The fold drains the
//   wgmma pipeline once a tile; at N = 88 the second set spills about 100
//   bytes under the 96-register cap. chip_smoke.py (b) holds the kernel to
//   an f64 sum on rows of 178 tiles.
// * The transpose orientation is the same kernel with the tile slab taken as
//   [64, tb] (64 tile rows = k, tb columns = m) and read MN-major by wgmma.
// * Each accumulator is written once; rows past n and columns past d are
//   masked in the epilogue. No atomics: the same bits on every run.
// * bf16 h (compute_dtype='bfloat16') is its own single bf16 plane: the kernel
//   is built with the plane count P (3 for f32 h, 1 for bf16 h) as a template
//   parameter, the pre-pass then only writes h K-major, a stage shrinks to
//   (tb + P N) x 128 B so four stages fit at every N, one tensor-core pass
//   replaces three, and the f32 accumulators are rounded to bf16 once where
//   they are stored. The bound stays the tiles' bytes.
//
// B. bsr_tile_kernel (below it): f32 tiles (bsr_dtype='float32'), tile sizes
// that are no multiple of 64, and d > 88. CUDA-core f32 FMAs, bound by
// operations (2*K*tb*tb*d at 67 TFLOP/s). One CTA owns one (block row, 32-wide
// feature chunk) and loops over that row's tiles,
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
// passes 2^31 at 4x reddit). bf16 h is read as bf16 and converted to f32 as it
// is staged, the sums stay f32 and out is stored in bf16; with f32 tiles each
// tile value is first rounded to bf16, as the TPU kernel casts its tiles to
// h's type (cuda_gcn_tpu/ops/pallas_bsr.py:79).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---- A. bf16 tiles on the tensor cores --------------------------------------

namespace mma {

using namespace hopper;

constexpr int kSlabK = 64;             // tile columns (k) per stage
constexpr int kRowBytes = kSlabK * 2;  // a shared-memory row: 64 bf16, one swizzle span
constexpr int kWgBytes = 64 * kRowBytes;  // a warpgroup's 64 rows (or 64 k) of the slab
constexpr int kMaxWgs = 4;             // consumer warpgroups at tb = 256
constexpr int kMaxThreads = kMaxWgs * 128 + 32;  // and the producer warp
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;     // dynamic shared memory a CTA can opt in to
constexpr int kSplitRows = 64;         // rows of h per CTA of the pre-pass
constexpr int kSplitThreads = 256;
constexpr int kMaxN = 88;

// x = part[0] + ... + part[P-1], each part x's remainder rounded to bf16
// (nearest even): hi, mid, lo for P = 3; for a bf16 x (P = 1) the one part is
// x exactly.
template <int P>
__device__ __forceinline__ void split(float x, uint32_t part[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat16 b = __float2bfloat16_rn(x);
    part[p] = __bfloat16_as_ushort(b);
    x -= __bfloat162float(b);  // exact in f32
  }
}

// planes[p][f][row], p < P: the bf16 parts of h[row, f] (HT is f32 with P = 3,
// or bf16 with P = 1); zero for row >= n and for d <= f < n_pad. One CTA reads
// 64 rows of h with coalesced loads and writes them transposed, 8 rows (16
// bytes) per thread and plane.
template <class HT, int P>
__global__ void __launch_bounds__(kSplitThreads)
split_planes_kernel(const HT* __restrict__ h, __nv_bfloat16* __restrict__ planes, int n,
                    int d, int n_pad, int64_t rows_pad) {
  __shared__ float hs[kSplitRows][kMaxN + 1];
  const int t = threadIdx.x;
  const int row0 = blockIdx.x * kSplitRows;
  const int64_t base = (int64_t)row0 * d, limit = (int64_t)n * d;
  for (int e = t; e < kSplitRows * d; e += kSplitThreads)
    hs[e / d][e % d] = base + e < limit ? to_f32(h[base + e]) : 0.f;
  __syncthreads();
  const int i0 = (t % 8) * 8;
  for (int f = t / 8; f < n_pad; f += kSplitThreads / 8) {
    uint32_t w[P][4];  // per plane, 8 rows as 4 bf16 pairs (lower row in the low half)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t lo_row[P], hi_row[P];
      split<P>(f < d ? hs[i0 + 2 * q][f] : 0.f, lo_row);
      split<P>(f < d ? hs[i0 + 2 * q + 1][f] : 0.f, hi_row);
#pragma unroll
      for (int p = 0; p < P; ++p) w[p][q] = lo_row[p] | (hi_row[p] << 16);
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      *reinterpret_cast<uint4*>(planes + ((int64_t)p * n_pad + f) * rows_pad + row0 + i0) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

// Two values of a row of out, at col and col + 1 (an aligned pair when
// `pairs`), each only if it lies below d.
__device__ __forceinline__ void store_pair(float* o, int col, int d, bool pairs, float v0,
                                           float v1) {
  if (pairs) {
    if (col < d) *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
  } else {
    if (col < d) o[col] = v0;
    if (col + 1 < d) o[col + 1] = v1;
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* o, int col, int d, bool pairs,
                                           float v0, float v1) {
  if (pairs) {
    if (col < d) *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < d) o[col] = __float2bfloat16_rn(v0);
    if (col + 1 < d) o[col + 1] = __float2bfloat16_rn(v1);
  }
}

// Shared memory, from a 1024-byte boundary: `stages` stages of
// [tile slab tb x 128 B | plane slabs P x N x 128 B], then the barriers. out
// is of h's type, OutT.
template <int N, int TA, int P, class OutT>
__global__ void __launch_bounds__(kMaxThreads, 1)
bsr_mma_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, const int* __restrict__ ptr,
               const int* __restrict__ order, const int* __restrict__ hblk,
               const int* __restrict__ row_order, OutT* __restrict__ out, int n, int d,
               int tb, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int a_bytes = tb * kRowBytes;
  constexpr int kBBytes = P * N * kRowBytes;
  const int stage_bytes = a_bytes + kBBytes;
  const uint32_t bars = base + stages * stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kMaxStages + s); };

  const int nwg = tb / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row_order ? row_order[blockIdx.x] : blockIdx.x;
  const int beg = ptr[r], end = ptr[r + 1];
  const int nk = tb / kSlabK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);         // the producer's arrive; the bytes ride on it
      mbar_init(empty(s), nwg * 4);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == nwg * 4) {
    // ---- producer: one thread keeps the ring full
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      int next_tile = beg < end ? order[beg] : 0, next_hb = beg < end ? hblk[beg] : 0;
      for (int p = beg; p < end; ++p) {
        const int tile = next_tile, hb = next_hb;
        if (p + 1 < end) {  // the next tile's ids arrive while this tile's slabs are requested
          next_tile = order[p + 1];
          next_hb = hblk[p + 1];
        }
        for (int kk = 0; kk < nk; ++kk) {
          mbar_wait(empty(s), phase ^ 1);  // passes at once on the first round
          const uint32_t dst = base + s * stage_bytes;
          mbar_arrive_expect_tx(full(s), stage_bytes);
          if (TA == 0) {  // [tb rows, 64 columns = k] of the tile
            tma_load_2d(dst, &map_a, full(s), kk * kSlabK, tile * tb);
          } else {        // [64 rows = k, 64 columns = m] per warpgroup
            for (int w = 0; w < nwg; ++w)
              tma_load_2d(dst + w * kWgBytes, &map_a, full(s), w * 64,
                          tile * tb + kk * kSlabK);
          }
          tma_load_3d(dst + a_bytes, &map_b, full(s), hb * tb + kk * kSlabK, 0, 0);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the block row
    const int wg = warp / 4;
    float acc[N / 2], total[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = total[i] = 0.f;
    const int steps = (end - beg) * nk;
    int s = 0, prev = -1;  // prev: the stage of a group that may still be in flight
    uint32_t phase = 0;
    for (int it = 0; it < steps; ++it) {
      mbar_wait(full(s), phase);
      const uint32_t a0 = base + s * stage_bytes + wg * kWgBytes;
      const uint32_t b0 = base + s * stage_bytes + a_bytes;
      wgmma_fence();
#pragma unroll
      for (int pl = 0; pl < P; ++pl)
#pragma unroll
        for (int k = 0; k < kSlabK / 16; ++k)
          // 16 k further on: 32 bytes along a K-major row, 16 rows of an MN-major slab
          Wgmma<N, TA>::run(acc, wgmma_desc(a0 + (TA ? k * 16 * kRowBytes : k * 32)),
                            wgmma_desc(b0 + pl * N * kRowBytes + k * 32));
      wgmma_commit();
      if ((it + 1) % nk == 0) {
        // a tile's last stage: its sums go into total with IEEE adds and the
        // next tile starts from zero (see "Accuracy" above)
        wgmma_wait<0>();
        if (lane == 0) {
          if (prev >= 0) mbar_arrive(empty(prev));
          mbar_arrive(empty(s));
        }
#pragma unroll
        for (int i = 0; i < N / 2; ++i) total[i] += acc[i], acc[i] = 0.f;
        prev = -1;
      } else {
        if (prev >= 0) {  // the group before this one has read its stage: hand it back
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty(prev));
        }
        prev = s;
      }
      if (++s == stages) s = 0, phase ^= 1;
    }

    // accumulator fragment: warp w4 of the warpgroup holds rows 16 w4 + lane / 4
    // and + 8; acc[4 j + 2 half + {0, 1}] are columns 8 j + 2 (lane % 4) + {0, 1}
    const int row_in = wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col0 = (lane % 4) * 2;
    const bool pairs = d % 2 == 0;  // then every 8-byte store is aligned and whole
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = (int64_t)r * tb + row_in + half * 8;
      if (row < n) {
        OutT* o = out + row * d;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          store_pair(o, j * 8 + col0, d, pairs, total[4 * j + 2 * half],
                     total[4 * j + 2 * half + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime so that the library
// links nothing beyond cudart.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor of `rank` dimensions (innermost first) as a tensor map with
// 128-byte swizzle; box[0] is 64 elements, the swizzle span.
bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides_bytes, const cuuint32_t* box) {
  const cuuint32_t ones[3] = {1, 1, 1};
  EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class OutT>
struct Args {
  CUtensorMap map_a, map_b;
  const int *ptr, *order, *hblk, *row_order;
  OutT* out;
  int n, d, tb, t_blocks, stages, smem;
  cudaStream_t stream;
};

template <int N, int TA, int P, class OutT>
cudaError_t launch(const Args<OutT>& a) {
  auto kernel = bsr_mma_kernel<N, TA, P, OutT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.t_blocks, a.tb / 64 * 128 + 32, a.smem, a.stream>>>(
      a.map_a, a.map_b, a.ptr, a.order, a.hblk, a.row_order, a.out, a.n, a.d, a.tb, a.stages);
  return cudaGetLastError();
}

template <int N, int P, class OutT>
cudaError_t launch(const Args<OutT>& a, int transpose) {
  return transpose ? launch<N, 1, P>(a) : launch<N, 0, P>(a);
}

// The accumulator width for d features: a wgmma N that the kernel is built for.
int padded_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 48 ? 48 : kMaxN;
}

// HT is h's type and out's: f32 h runs as its three bf16 parts (P = 3), bf16
// h as itself (P = 1).
template <class HT>
cudaError_t contract(const int* ptr, const int* order, const int* hblk, const int* row_order,
                     const __nv_bfloat16* tiles, const HT* h, __nv_bfloat16* planes,
                     HT* out, int n, int d, int tb, int t_blocks, int k_tiles,
                     int transpose, cudaStream_t stream) {
  constexpr int P = sizeof(HT) == 4 ? 3 : 1;
  if (tb % 64 || tb > 64 * kMaxWgs || d > kMaxN || k_tiles < 1) return cudaErrorInvalidValue;
  const int n_pad = padded_width(d);
  const int64_t rows_pad = (int64_t)t_blocks * tb;
  split_planes_kernel<HT, P><<<rows_pad / kSplitRows, kSplitThreads, 0, stream>>>(
      h, planes, n, d, n_pad, rows_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Args<HT> a;
  // the tiles as one [K tb, tb] matrix; a box is tb x 64, or 64 x 64 transposed
  const cuuint64_t a_dims[2] = {(cuuint64_t)tb, (cuuint64_t)k_tiles * tb};
  const cuuint64_t a_strides[1] = {(cuuint64_t)tb * 2};
  const cuuint32_t a_box[2] = {kSlabK, (cuuint32_t)(transpose ? 64 : tb)};
  // the planes [P][n_pad][rows_pad]; a box is all P planes' [n_pad, 64]
  const cuuint64_t b_dims[3] = {(cuuint64_t)rows_pad, (cuuint64_t)n_pad, (cuuint64_t)P};
  const cuuint64_t b_strides[2] = {(cuuint64_t)rows_pad * 2, (cuuint64_t)rows_pad * 2 * n_pad};
  const cuuint32_t b_box[3] = {kSlabK, (cuuint32_t)n_pad, (cuuint32_t)P};
  if (!bf16_map(&a.map_a, tiles, 2, a_dims, a_strides, a_box) ||
      !bf16_map(&a.map_b, planes, 3, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  const int stage_bytes = (tb + P * n_pad) * kRowBytes;
  const int barrier_bytes = 2 * kMaxStages * 8;
  a.stages = (kSmemLimit - 1024 - barrier_bytes) / stage_bytes;
  if (a.stages > kMaxStages) a.stages = kMaxStages;
  a.smem = 1024 + a.stages * stage_bytes + barrier_bytes;
  a.ptr = ptr, a.order = order, a.hblk = hblk, a.row_order = row_order, a.out = out;
  a.n = n, a.d = d, a.tb = tb, a.t_blocks = t_blocks, a.stream = stream;
  switch (n_pad) {
    case 16: return launch<16, P>(a, transpose);
    case 32: return launch<32, P>(a, transpose);
    case 48: return launch<48, P>(a, transpose);
    default: return launch<kMaxN, P>(a, transpose);
  }
}

}  // namespace mma

// ---- B. f32 FMAs on the CUDA cores ------------------------------------------

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

// A tile value for h of type HT: as it is, or rounded to bf16 for bf16 h.
template <typename HT>
__device__ __forceinline__ float tile_value(float a) {
  if constexpr (sizeof(HT) == 2)
    return __bfloat162float(__float2bfloat16_rn(a));
  else
    return a;
}

template <typename TileT>
struct Staged {
  static constexpr int kPerVec = 16 / sizeof(TileT);  // elements per 16-byte load
  static constexpr int kVecs = kMaxTb * kJ / kPerVec / kThreads;
  uint4 tile[kVecs];
  float h[kHPerThread];
};

// Registers <- the step's [tb, 32] slice of A and [32, 32] slice of h.
template <typename TileT, typename HT>
__device__ __forceinline__ void load_step(Staged<TileT>& st, const TileT* tile,
                                          int64_t hrow0, int j0, int tb, int transpose,
                                          const HT* __restrict__ h, int n, int d,
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
    st.h[q] = (row < n && f < d) ? to_f32(h[row * d + f]) : 0.f;
  }
}

// Shared memory <- registers: ts[i][jj] = A[i][j0 + jj] (as f32, rounded to
// bf16 first for bf16 h), hs[jj][ff].
template <typename TileT, typename HT>
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
        for (int e = 0; e < kPerVec; ++e)
          ts[i * kTsStride + jj0 + e] = tile_value<HT>(elem<TileT>(st.tile[q], e));
      } else {
        const int jj = v / (tb / kPerVec), i0 = (v % (tb / kPerVec)) * kPerVec;
#pragma unroll
        for (int e = 0; e < kPerVec; ++e)
          ts[(i0 + e) * kTsStride + jj] = tile_value<HT>(elem<TileT>(st.tile[q], e));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kHPerThread; ++q) hs[t + q * kThreads] = st.h[q];
}

template <typename TileT, typename HT>
__global__ void __launch_bounds__(kThreads)
bsr_tile_kernel(const int* __restrict__ ptr, const int* __restrict__ order,
                const int* __restrict__ hblk, const TileT* __restrict__ tiles,
                const HT* __restrict__ h, HT* __restrict__ out, int n,
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
    store_step<TileT, HT>(st, ts, hs, tb, transpose, t);
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
        if (f < d) {
          if constexpr (sizeof(HT) == 2)
            out[row * d + f] = __float2bfloat16_rn(acc[s][ff]);
          else
            out[row * d + f] = acc[s][ff];
        }
      }
    }
  }
}

}  // namespace

namespace {

template <class HT>
cudaError_t contract_as(const int* p, const int* o, const int* hb, const void* row_order,
                        const void* tiles, int tiles_bf16, const void* h, void* planes,
                        void* out, int n, int d, int tb, int t_blocks, int k_tiles,
                        int transpose, cudaStream_t s) {
  const HT* hh = static_cast<const HT*>(h);
  HT* oo = static_cast<HT*>(out);
  if (planes != nullptr) {
    if (!tiles_bf16) return cudaErrorInvalidValue;
    return mma::contract<HT>(p, o, hb, static_cast<const int*>(row_order),
                             static_cast<const __nv_bfloat16*>(tiles), hh,
                             static_cast<__nv_bfloat16*>(planes), oo, n, d, tb, t_blocks,
                             k_tiles, transpose, s);
  }
  const dim3 grid((d + kFeat - 1) / kFeat, t_blocks);
  if (tiles_bf16) {
    bsr_tile_kernel<__nv_bfloat16, HT><<<grid, kThreads, 0, s>>>(
        p, o, hb, static_cast<const __nv_bfloat16*>(tiles), hh, oo, n, d, tb, transpose);
  } else {
    bsr_tile_kernel<float, HT><<<grid, kThreads, 0, s>>>(
        p, o, hb, static_cast<const float*>(tiles), hh, oo, n, d, tb, transpose);
  }
  return cudaGetLastError();
}

}  // namespace

// `planes` is the scratch of the tensor-core kernel, P * N * t_blocks * tb
// bf16 for N = d rounded up as padded_width does (P = 3 for f32 h, 1 for bf16
// h); null takes the FMA kernel. `row_order` (may be null) is the order in
// which the CTAs take the block rows. `h_dtype` is 0 for f32 h and out, 1 for
// bf16; another code is refused.
extern "C" int bsr_tile_contract(const void* ptr, const void* order, const void* hblk,
                                 const void* row_order, const void* tiles, int tiles_bf16,
                                 const void* h, void* planes, void* out, int n, int d,
                                 int tb, int t_blocks, int k_tiles, int transpose, int h_dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* o = static_cast<const int*>(order);
  const int* hb = static_cast<const int*>(hblk);
  if (h_dtype == 0)
    return static_cast<int>(contract_as<float>(p, o, hb, row_order, tiles, tiles_bf16, h,
                                               planes, out, n, d, tb, t_blocks, k_tiles,
                                               transpose, s));
  if (h_dtype == 1)
    return static_cast<int>(contract_as<__nv_bfloat16>(p, o, hb, row_order, tiles, tiles_bf16,
                                                       h, planes, out, n, d, tb, t_blocks,
                                                       k_tiles, transpose, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
