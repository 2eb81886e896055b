// Layer 0 of the GCN and the GAT on dense features in training: the dropout
// of x and both products of the fused epoch's pair, in one pass over x.
//
//   keep[r, k] = the element's uniform bits < q * 2^bits, q = 1 - p
//   xd[r, k]   = keep ? x[r, k] / q : 0          in x's type, kept for dW
//   zt[r, :]   = sum_k xd[r, k] * W[k, :]        in x's type, summed in f32
//   ze[r, :]   = sum_k x[r, k]  * W[k, :]        the eval half, when asked for
//
// Replaces no TPU kernel. The JAX package writes the layer as jnp operations
// (cuda_gcn_tpu/models/gcn.py:32-48), and XLA fuses the dropout's compare,
// scale and select into the product's operand there. On the card ATen ran it
// as six launches (rand, compare, scale, where, and two GEMMs that each read
// x), about 4.2 GB of traffic at synth-reddit's x (232,965 x 602 f32, 561 MB).
// This kernel reads x once and writes xd and the products once: 1.15 GB,
// 0.343 ms at 3.35 TB/s.
//
// Bound on the H100, at 16 columns: bytes. The work beside them is not small:
// 2 x 16 FMAs an element (9.0 GFLOP of f32 at synth-reddit, 0.13 ms at 67
// TFLOP/s) and the mask's Philox rounds, so it has to run under the copies.
// At 64 columns (the GAT's 8 heads x 8) the FMAs bound it: 2 x 64 an element,
// 35.9 GFLOP at synth-reddit, 0.54 ms at 67 TFLOP/s, where x read once, xd
// written once and both products (1.24 GB) take 0.37 ms at 3.35 TB/s.
//
// Everywhere:
//
// * Every output has one writer and a fixed order of additions: no atomics,
//   the same bits on every run.
// * The mask is drawn in the kernel with Philox4x32-10, keyed by a seed and an
//   offset that the caller draws on the device from the job's generator (two
//   int64 read here from device memory: a replayed CUDA graph draws a fresh
//   mask, and the host reads nothing). An element takes 8 bits of a uniform
//   where q * 2^8 is whole (p = 0.5: 16 elements a call), else 32; the layout
//   of the calls is ops/matmul.layer0_keep's (call_of, bits_of), which does
//   not depend on W's columns. A thread draws its next call before it sums
//   the current one, so that the integer chain runs under the FMAs.
// * xd is written over x in shared memory as it is made, and leaves for
//   device memory from there.
//
// Three ways through x (kernels.layer0_path chooses by W's width and by what
// fits):
//
// * 'flat', at 16 columns and fewer (the GCN's hidden 16 on synth-reddit and
//   pubmed): lanes are rows of x, a warp walks its rows together along k, W's
//   row k is a broadcast from shared memory (4 16-byte loads), and each
//   thread keeps its rows' 2 x 16 sums in registers. A block of 32 rows is one
//   contiguous range of x (77 KB at F = 602 f32). A persistent CTA a SM has 8
//   warps that compute and one that copies: its lane 0 moves whole blocks by
//   bulk copies (the TMA), loading a block into one of two stages while the
//   other is summed, storing its xd once the warps release it, and loading
//   the next block into the stage once the store has read it out. Device
//   memory sees long sequential reads and writes, as a plain copy does, and
//   the computing warps never wait on a store. W stays whole in shared
//   memory, its rows zero-filled to a multiple of 8. Each lane takes two rows,
//   r and r + 16, so that one load of W's row serves two elements; the two
//   half-warps take a warp's units of 8 columns in turn (the warps have even
//   shares of the units), add their sums by a shuffle, and the warps' partial
//   sums are added in warp order through shared memory. Rows keep x's layout
//   there: 2-way bank conflicts at F = 602, 4-way at F = 500.
// * 'wide', above 16 columns, 64 a launch (one launch for the GAT's 64; a
//   wider W takes one per 64): a thread owns one row and all 64 columns of
//   both products, 128 sums in registers, so each element of x is read, masked
//   and divided by one thread and feeds 128 FMAs, with W's row k broadcast
//   from shared memory in 16 16-byte loads, and no sums are added across
//   threads. An element's work goes four at a time: the four quotients side
//   by side, then their FMAs, so that one chain's latency does not hold the
//   FMAs up. W
//   (154 KB at F = 602) stays whole in shared memory, which leaves no room for
//   the flat way's stages of 32 whole rows, nor for a second copy of x that
//   threads splitting the columns would need for their x @ W once xd is
//   written over x. So each of a persistent CTA's 8 warps takes its own tiles
//   of 32 rows and streams them in chunks of 32 columns through two stages of
//   its own (8.4 KB at f32), copied one 4-byte word a lane from the word below
//   each row's first element and read a lane a row (rows padded to an odd
//   number of words: no bank conflicts); the warp stores its rows' xd from
//   the stage with the lanes along the row, then copies the next chunk into
//   it while it sums the other.
// * 'chunked', at 16 columns and fewer, for an F whose two blocks do not fit
//   beside W (F above 619 at f32), for an x that does not start on 16 bytes,
//   and above 16 columns where the wide way does not fit: a CTA of 4 warps, a
//   lane a row, takes 128 rows and streams them through a ring of chunks of
//   64 columns, copied as the wide way copies, with the chunk's 64 rows of W
//   beside them, zero-filled past F; each warp stores its rows' xd with the
//   lanes along the row. The host launches it once per 16 columns, only the
//   first launch writing xd.
//
// The division is correctly rounded (x / q in f32); where q is a power of two
// it is the exact product x * (1 / q). The wide way takes it as x times 1 / q
// in f64, rounded once (div_by_q): the same bits, without the division's
// branch to its slow path, around which the compiler kept each element's
// loads from overlapping the FMAs before them (1.87 ms against 2.53 at
// synth-reddit's 602 -> 64 on the H100). bf16 x: xd is the f32 quotient rounded
// to bf16, W is rounded to bf16 in shared memory, and the products of bf16
// values are summed in f32 and rounded once, as the bf16 GEMM of
// ops/matmul.py dense_matmul does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWidth = 16;        // output columns a launch of the flat and chunked ways
constexpr int kSmemMax = 232448;  // shared memory a CTA may opt into on the H100

// the chunked way
constexpr int kThreads = 128;  // 4 warps, a lane a row
constexpr int kRows = kThreads;
constexpr int kBk = 64;        // columns of x (rows of W) a chunk
constexpr int kStages = 3;
static_assert(kRows % 32 == 0 && kBk % 32 == 0 && kBk * 16 % kThreads == 0, "tile shapes");

// the flat way: 8 warps that compute and one that copies
constexpr int kFlatWarps = 8;
constexpr int kFlatThreads = 32 * kFlatWarps;

// the wide way: 8 warps, each its own tiles of 32 rows, a lane a row
constexpr int kWideCols = 64;  // output columns a launch
constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideBk = 32;    // columns of x a chunk

template <class T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const char* p) {
    return *reinterpret_cast<const float*>(p);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store_smem(char* p, float v) {
    *reinterpret_cast<float*>(p) = v;
  }
  static __device__ __forceinline__ void store_global(void* p, float v) {
    __stcs(reinterpret_cast<float*>(p), v);
  }
  static __device__ __forceinline__ void store(void* p, float v) {
    *reinterpret_cast<float*>(p) = v;
  }
};
template <>
struct Elem<bf16> {
  static __device__ __forceinline__ float load(const char* p) {
    return __bfloat162float(*reinterpret_cast<const bf16*>(p));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store_smem(char* p, float v) {
    *reinterpret_cast<bf16*>(p) = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void store_global(void* p, float v) {
    __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
  }
  static __device__ __forceinline__ void store(void* p, float v) {
    *reinterpret_cast<bf16*>(p) = __float2bfloat16_rn(v);
  }
};

// Chunked: 32-bit words of shared memory a row's chunk takes (see the top).
template <class T>
__host__ __device__ constexpr int row_words() {
  return kBk * static_cast<int>(sizeof(T)) / 4 + 1;
}

template <class T>
__host__ __device__ constexpr int stage_bytes() {
  return (kRows * row_words<T>() + kBk * kWidth) * 4;
}

// Flat: two stages, each a block of 32 rows and 16 bytes that a masked read
// past its last row may touch; W whole, its rows zero-filled to a multiple
// of 8 (a unit's columns past F read W there); the warps' partial sums of a
// block, a row of them padded to an odd number of words; and the stages'
// full and empty barriers.
__host__ __device__ constexpr int red_words(bool eval) {
  return (eval ? 2 * kWidth : kWidth) + 1;
}

__host__ __device__ inline long long flat_stage_bytes(int f, int item) {
  return (32LL * f * item + 15) / 16 * 16 + 16;
}

__host__ __device__ inline int flat_w_rows(int f) { return (f + 7) / 8 * 8; }

__host__ __device__ inline long long flat_smem_bytes(int f, int item, bool eval) {
  return 2 * flat_stage_bytes(f, item) + 4LL * flat_w_rows(f) * kWidth +
         4LL * kFlatWarps * 32 * red_words(eval) + 4 * 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; `bytes` 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit uniforms of `ctr` under `key`.
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

__device__ __forceinline__ uint32_t lane_of(const uint4& u, int e) {
  return e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
}

struct Args {
  const char* x;            // [n, f] of T
  const float* w;           // [f, ldw] f32; this launch's columns start here
  const long long* seeds;   // Philox key and counter offset, drawn on the device
  char* xd;                 // [n, f] of T, or null: the columns' xd is another launch's
  char* zt;                 // [n, ldw] of T; this launch's columns start here
  char* ze;                 // the same, or null: no eval half
  long long n;
  int f;
  int ldw;
  int cols;                 // output columns of this launch: at most kWidth, kWideCols wide
  float q;                  // 1 - p
  float inv_q;              // 1 / q where q is a power of two
  int q_pow2;
  uint32_t thresh;          // keep where the uniform is below it
};

struct Draw {  // the Philox key and counter offset of a launch
  uint2 key;
  uint32_t off_lo, off_hi;
};

__device__ __forceinline__ Draw read_draw(const Args& a) {
  const unsigned long long seed = static_cast<unsigned long long>(__ldg(a.seeds));
  const unsigned long long offset = static_cast<unsigned long long>(__ldg(a.seeds + 1));
  return Draw{make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32)),
              static_cast<uint32_t>(offset), static_cast<uint32_t>(offset >> 32)};
}

__device__ __forceinline__ uint4 draw_at(const Draw& d, unsigned long long group) {
  return philox(d.key, make_uint4(static_cast<uint32_t>(group), static_cast<uint32_t>(group >> 32),
                                  d.off_lo, d.off_hi));
}

// The uniforms (kernels.dropout_keep, ops/matmul.layer0_keep): at B = 32
// bits an element a Philox call covers 4 columns of one row, a word each; at
// B = 8 it covers 8 columns of two rows of a block of 32, r and r + 16 (a
// row "pair"): words 0 and 1 the lower row's columns 0-3 and 4-7, a byte
// each from the lowest, words 2 and 3 the upper row's.
template <int B>
__device__ __forceinline__ unsigned long long call_of(const Args& a, long long row, int col) {
  if constexpr (B == 32) {
    return static_cast<unsigned long long>(row) * ((a.f + 3) / 4) + col / 4;
  } else {
    const long long pair = row / 32 * 16 + row % 16;
    return static_cast<unsigned long long>(pair) * ((a.f + 7) / 8) + col / 8;
  }
}

// The element's bits of a call: column `c` of its 4 (B 32) or 8 (B 8), in
// the lower (upper 0) or upper row of its pair.
template <int B>
__device__ __forceinline__ uint32_t bits_of(const uint4& u, int upper, int c) {
  if constexpr (B == 32) {
    return lane_of(u, c);
  } else {
    return (lane_of(u, 2 * upper + c / 4) >> (8 * (c % 4))) & 0xFFu;
  }
}

// The terms of one element in HP columns: xd and (EVAL) x times W's row,
// `w4` its HP / 4 quads (in registers or in shared memory).
template <int HP, bool EVAL>
__device__ __forceinline__ void accumulate(float xdv, float xv, const float4* w4, float* acc_t,
                                           float* acc_e) {
#pragma unroll
  for (int h4 = 0; h4 < HP / 4; ++h4) {
    const float4 w = w4[h4];
    acc_t[4 * h4 + 0] = fmaf(xdv, w.x, acc_t[4 * h4 + 0]);
    acc_t[4 * h4 + 1] = fmaf(xdv, w.y, acc_t[4 * h4 + 1]);
    acc_t[4 * h4 + 2] = fmaf(xdv, w.z, acc_t[4 * h4 + 2]);
    acc_t[4 * h4 + 3] = fmaf(xdv, w.w, acc_t[4 * h4 + 3]);
    if (EVAL) {
      acc_e[4 * h4 + 0] = fmaf(xv, w.x, acc_e[4 * h4 + 0]);
      acc_e[4 * h4 + 1] = fmaf(xv, w.y, acc_e[4 * h4 + 1]);
      acc_e[4 * h4 + 2] = fmaf(xv, w.z, acc_e[4 * h4 + 2]);
      acc_e[4 * h4 + 3] = fmaf(xv, w.w, acc_e[4 * h4 + 3]);
    }
  }
}

// One element: its mask, xd written over x at `p`, and its terms of the sums.
template <class T, bool EVAL>
__device__ __forceinline__ void element(const Args& a, char* p, float xv, uint32_t bits,
                                        bool store, const float4* w4, float* acc_t,
                                        float* acc_e) {
  const float scaled = a.q_pow2 ? xv * a.inv_q : __fdiv_rn(xv, a.q);
  const float xdv = bits < a.thresh ? Elem<T>::round(scaled) : 0.0f;
  if (store) Elem<T>::store_smem(p, xdv);
  accumulate<kWidth, EVAL>(xdv, xv, w4, acc_t, acc_e);
}

// The chunked way's thread: its row over `kc` columns from `xrow` (its first
// column's bytes in shared memory, whose W rows start at `ws`), column `col0`
// of row `row`, a multiple of 8. TAIL: kc may end inside a word; the columns
// past it are neither summed nor written.
template <class T, bool EVAL, bool TAIL, int B>
__device__ __forceinline__ void compute_row(const Args& a, char* xrow, const float* ws,
                                            const Draw& d, long long row, int col0, int kc,
                                            float* acc_t, float* acc_e) {
  constexpr int HP = kWidth;
  constexpr int kCols = B == 32 ? 4 : 8;  // columns of the row a call covers
  const int upper = static_cast<int>(row % 32) / 16;
  const int calls = (kc + kCols - 1) / kCols;
  uint4 u = draw_at(d, call_of<B>(a, row, col0));
#pragma unroll 1
  for (int g = 0; g < calls; ++g) {
    const uint4 u_next = draw_at(d, call_of<B>(a, row, col0 + kCols * (g + 1)));  // last: unused
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int kk = kCols * g + c;
      if (!TAIL || kk < 4 * ((kc + 3) / 4)) {
        char* p = xrow + kk * static_cast<int>(sizeof(T));
        float xv = Elem<T>::load(p);
        if (TAIL && kk >= kc) xv = 0.0f;
        float4 w4[HP / 4];
#pragma unroll
        for (int h4 = 0; h4 < HP / 4; ++h4) w4[h4] = reinterpret_cast<const float4*>(ws + kk * HP)[h4];
        element<T, EVAL>(a, p, xv, bits_of<B>(u, upper, c), !TAIL || kk < kc, w4, acc_t, acc_e);
      }
    }
    u = u_next;
  }
}

template <class T>
__device__ __forceinline__ void round_w(float* ws, int idx) {
  if constexpr (sizeof(T) == 2) ws[idx] = Elem<T>::round(ws[idx]);
}

// ---- the flat way -----------------------------------------------------------

// The byte range of x (and xd) that block `blk` of 32 rows covers.
template <class T>
__device__ __forceinline__ void block_bytes(const Args& a, long long blk, long long* begin,
                                            int* bytes) {
  *begin = blk * 32 * a.f * static_cast<long long>(sizeof(T));
  *bytes = static_cast<int>(min(blk * 32 + 32, a.n) * a.f * static_cast<long long>(sizeof(T)) -
                            *begin);
}

// The copying warp's lane 0: block `blk` into `stage`, the bytes past the
// last 16-byte boundary by hand, the rest by one bulk copy counted on `full`.
template <class T>
__device__ __forceinline__ void flat_load(const Args& a, char* stage, long long blk, uint32_t full) {
  long long begin;
  int bytes;
  block_bytes<T>(a, blk, &begin, &bytes);
  const int whole = bytes / 16 * 16;
  for (int j = whole; j < bytes; j += 2) {
    *reinterpret_cast<uint16_t*>(stage + j) = *reinterpret_cast<const uint16_t*>(a.x + begin + j);
  }
  hopper::mbar_arrive_expect_tx(full, whole);
  if (whole) hopper::bulk_load(smem_addr(stage), a.x + begin, whole, full);
}

// The copying warp's lane 0: block `blk`'s xd from `stage`, likewise, as one
// bulk group; nothing where another launch of the call writes xd.
template <class T>
__device__ __forceinline__ void flat_store(const Args& a, const char* stage, long long blk) {
  if (a.xd == nullptr) return;
  long long begin;
  int bytes;
  block_bytes<T>(a, blk, &begin, &bytes);
  const int whole = bytes / 16 * 16;
  if (whole) hopper::bulk_store(a.xd + begin, smem_addr(stage), whole);
  hopper::bulk_commit();
  for (int j = whole; j < bytes; j += 2) {
    *reinterpret_cast<uint16_t*>(a.xd + begin + j) = *reinterpret_cast<const uint16_t*>(stage + j);
  }
}

__device__ __forceinline__ void compute_barrier() {  // the computing warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFlatThreads) : "memory");
}

// The flat way's lane over one unit of 8 columns (from column k0) of its two
// rows, `lo` and `lo` + 16 rows (`row_bytes` apart) of the stage: masks, xd
// written over x, sums. TAIL: the unit ends past F; its columns past F are
// neither summed nor written.
template <class T, bool EVAL, bool TAIL, int B>
__device__ __forceinline__ void flat_unit(const Args& a, char* lo, long long row_bytes,
                                          const float* ws, const Draw& d, long long row, int k0,
                                          const uint4& u8, float (&acc_t)[2][kWidth],
                                          float (&acc_e)[2][EVAL ? kWidth : 1]) {
  constexpr int HP = kWidth;
  uint4 u32[2];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int k = k0 + c;
    if (TAIL && k >= 4 * ((a.f + 3) / 4)) break;
    if constexpr (B == 32) {
      if (c % 4 == 0) {
        u32[0] = draw_at(d, call_of<32>(a, row, k));
        u32[1] = draw_at(d, call_of<32>(a, row + 16, k));
      }
    }
    float4 w4[HP / 4];
#pragma unroll
    for (int h4 = 0; h4 < HP / 4; ++h4) w4[h4] = reinterpret_cast<const float4*>(ws + k * HP)[h4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      char* p = lo + r * row_bytes + k * static_cast<long long>(sizeof(T));
      float xv = Elem<T>::load(p);
      if (TAIL && k >= a.f) xv = 0.0f;
      const uint32_t bits = B == 32 ? bits_of<32>(u32[r], 0, c % 4) : bits_of<8>(u8, r, c);
      element<T, EVAL>(a, p, xv, bits, !TAIL || k < a.f, w4, acc_t[r],
                           EVAL ? acc_e[r] : acc_e[0]);
    }
  }
}

template <class T, bool EVAL, int B>
__global__ void __launch_bounds__(kFlatThreads + 32, 1) layer0_flat_kernel(const Args a) {
  constexpr int HP = kWidth;
  constexpr int kRed = red_words(EVAL);
  constexpr int kOut = EVAL ? 2 * HP : HP;
  constexpr int kE = EVAL ? HP : 1;
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stage = flat_stage_bytes(a.f, sizeof(T));
  char* stages[2] = {smem, smem + stage};
  float* ws = reinterpret_cast<float*>(smem + 2 * stage);
  const int w_words = flat_w_rows(a.f) * HP;
  float* red = ws + w_words;
  const uint32_t bars = smem_addr(red + kFlatWarps * 32 * kRed);  // full[2], empty[2]
  const uint32_t full[2] = {bars, bars + 8}, empty[2] = {bars + 16, bars + 24};
  const long long blocks = (a.n + 31) / 32;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 4; ++b) hopper::mbar_init(bars + 8 * b, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kFlatWarps) {  // the copying warp: loads two blocks ahead, stores behind
    if (lane != 0) return;
    int i = 0;
    for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x, ++i) {
      const int s = i & 1;
      if (i >= 2) {  // block i - 2 is summed and its xd is in stage s: store it, then refill
        hopper::mbar_wait(empty[s], ((i - 2) >> 1) & 1);
        flat_store<T>(a, stages[s], blk - 2LL * gridDim.x);
        hopper::bulk_wait_read<0>();
      }
      flat_load<T>(a, stages[s], blk, full[s]);
    }
    for (int j = i < 2 ? 0 : i - 2; j < i; ++j) {
      hopper::mbar_wait(empty[j & 1], (j >> 1) & 1);
      flat_store<T>(a, stages[j & 1], blockIdx.x + static_cast<long long>(j) * gridDim.x);
    }
    hopper::bulk_wait<0>();
    return;
  }

  const Draw d = read_draw(a);
  const int half = lane >> 4, lo = lane & 15;  // rows lo and lo + 16; every other unit
  // the warp's units of 8 columns: an even share, taken by its halves in turn
  const int units = (a.f + 7) / 8;
  const int u_end = (warp + 1) * units / kFlatWarps;
  const int u_first = warp * units / kFlatWarps + half;
  const long long row_bytes = 16LL * a.f * static_cast<long long>(sizeof(T));
  const uint32_t wdst = smem_addr(ws);
  for (int idx = threadIdx.x; idx < w_words; idx += kFlatThreads) {
    const int k = idx / HP, h = idx % HP;
    const bool in = k < a.f && h < a.cols;
    cp_async4(wdst + idx * 4, in ? a.w + static_cast<long long>(k) * a.ldw + h : a.w, in ? 4 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  for (int idx = threadIdx.x; idx < w_words; idx += kFlatThreads) round_w<T>(ws, idx);
  compute_barrier();

  int i = 0;
  for (long long blk = blockIdx.x; blk < blocks; blk += gridDim.x, ++i) {
    const int s = i & 1;
    char* st = stages[s];
    hopper::mbar_wait(full[s], (i >> 1) & 1);
    float acc_t[2][HP], acc_e[2][kE];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int h = 0; h < HP; ++h) acc_t[r][h] = 0.0f;
#pragma unroll
      for (int h = 0; h < kE; ++h) acc_e[r][h] = 0.0f;
    }
    const long long row = blk * 32 + lo;
    char* xlo = st + lo * a.f * static_cast<long long>(sizeof(T));
    uint4 u = u_first < u_end && B == 8 ? draw_at(d, call_of<8>(a, row, 8 * u_first)) : uint4{};
#pragma unroll 1
    for (int unit = u_first; unit < u_end; unit += 2) {
      uint4 u_next = u;
      if (B == 8) u_next = draw_at(d, call_of<8>(a, row, 8 * (unit + 2)));  // last: unused
      if (8 * unit + 8 <= a.f) {
        flat_unit<T, EVAL, false, B>(a, xlo, row_bytes, ws, d, row, 8 * unit, u, acc_t, acc_e);
      } else {
        flat_unit<T, EVAL, true, B>(a, xlo, row_bytes, ws, d, row, 8 * unit, u, acc_t, acc_e);
      }
      u = u_next;
    }
    hopper::fence_proxy_async();  // this thread's xd, before the bulk store reads it
    // the halves' sums of each row, added; lane `half` keeps row lo + 16 * half
    float* mine = red + (warp * 32 + lo + 16 * half) * kRed;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        const float sum = acc_t[r][h] + __shfl_xor_sync(0xffffffffu, acc_t[r][h], 16);
        if (r == half) mine[h] = sum;
      }
      if (EVAL) {
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          const float sum = acc_e[r][h] + __shfl_xor_sync(0xffffffffu, acc_e[r][h], 16);
          if (r == half) mine[HP + h] = sum;
        }
      }
    }
    compute_barrier();
    if (threadIdx.x == 0) hopper::mbar_arrive(empty[s]);  // stage s: to store and refill
    for (int o = threadIdx.x; o < 32 * kOut; o += kFlatThreads) {
      const int r = o / kOut, c = o % kOut;
      const long long out_row = blk * 32 + r;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kFlatWarps; ++w) sum += red[(w * 32 + r) * kRed + c];
      const int h = c < HP ? c : c - HP;
      if (out_row < a.n && h < a.cols) {
        char* out = c < HP ? a.zt : a.ze;
        Elem<T>::store(out + (out_row * a.ldw + h) * static_cast<long long>(sizeof(T)), sum);
      }
    }
    compute_barrier();  // the partial sums are read: free for the next block
  }
}

// ---- the chunked way ----------------------------------------------------------

// Copy chunk `c` of the CTA's rows (each warp its own 32) and of W into `stage`.
template <class T>
__device__ __forceinline__ void load_chunk(const Args& a, char* stage, long long row0, int c) {
  constexpr int kWords = row_words<T>();
  constexpr int HP = kWidth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = c * kBk;
  const int kc = min(kBk, a.f - k0);
  const uint32_t xs = smem_addr(stage) + warp * 32 * kWords * 4;
  const long long wrow0 = row0 + warp * 32;
  const char* src = a.x + (wrow0 * a.f + k0) * static_cast<long long>(sizeof(T));
  const long long row_bytes = static_cast<long long>(a.f) * sizeof(T);
#pragma unroll 4
  for (int i = 0; i < 32; ++i, src += row_bytes) {
    if (wrow0 + i >= a.n) break;
    const uintptr_t at = reinterpret_cast<uintptr_t>(src);
    const uintptr_t base = at & ~static_cast<uintptr_t>(3);
    const int nw = static_cast<int>((at - base + kc * sizeof(T) + 3) >> 2);
#pragma unroll
    for (int j0 = 0; j0 < kWords; j0 += 32) {
      const int j = j0 + lane;
      if (j < nw) cp_async4(xs + (i * kWords + j) * 4, reinterpret_cast<const void*>(base + 4 * j), 4);
    }
  }
  const uint32_t ws = smem_addr(stage) + kRows * kWords * 4;
#pragma unroll
  for (int i = 0; i < kBk * HP / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int kk = idx / HP, hh = idx % HP;
    const bool in = kk < kc && hh < a.cols;
    cp_async4(ws + idx * 4, in ? a.w + static_cast<long long>(k0 + kk) * a.ldw + hh : a.w,
              in ? 4 : 0);
  }
}

template <class T, bool EVAL, int B>
__global__ void __launch_bounds__(kThreads, 2) layer0_pair_kernel(const Args a) {
  constexpr int kWords = row_words<T>();
  constexpr int HP = kWidth;
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long row = row0 + threadIdx.x;
  const int chunks = (a.f + kBk - 1) / kBk;
  const Draw d = read_draw(a);
  // the byte shift of this thread's row within its first word: the same in every chunk
  const int shift = static_cast<int>(
      reinterpret_cast<uintptr_t>(a.x + row * a.f * static_cast<long long>(sizeof(T))) & 3);

  float acc_t[HP], acc_e[EVAL ? HP : 1];
#pragma unroll
  for (int h = 0; h < HP; ++h) acc_t[h] = 0.0f;
#pragma unroll
  for (int h = 0; h < (EVAL ? HP : 1); ++h) acc_e[h] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load_chunk<T>(a, smem + s * stage_bytes<T>(), row0, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    char* stage = smem + (c % kStages) * stage_bytes<T>();
    float* ws = reinterpret_cast<float*>(stage + kRows * kWords * 4);
    cp_async_wait<kStages - 2>();
#pragma unroll
    for (int i = 0; i < kBk * HP / kThreads; ++i) round_w<T>(ws, threadIdx.x + i * kThreads);
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < chunks) load_chunk<T>(a, smem + (next % kStages) * stage_bytes<T>(), row0, next);
    cp_async_commit();

    const int k0 = c * kBk;
    const int kc = min(kBk, a.f - k0);
    char* xrow = stage + threadIdx.x * kWords * 4 + shift;
    if (kc == kBk) {
      compute_row<T, EVAL, false, B>(a, xrow, ws, d, row, k0, kc, acc_t, acc_e);
    } else {
      compute_row<T, EVAL, true, B>(a, xrow, ws, d, row, k0, kc, acc_t, acc_e);
    }
    __syncwarp();
    if (a.xd != nullptr) {  // the warp's 32 rows of xd, the lanes along each row
      const long long wrow0 = row0 + warp * 32;
      const char* rows = stage + warp * 32 * kWords * 4;
      for (int i = 0; i < 32 && wrow0 + i < a.n; ++i) {
        const long long at = ((wrow0 + i) * a.f + k0) * static_cast<long long>(sizeof(T));
        const char* from = rows + i * kWords * 4 + static_cast<int>(reinterpret_cast<uintptr_t>(a.x + at) & 3);
#pragma unroll
        for (int e0 = 0; e0 < kBk; e0 += 32) {
          const int e = e0 + lane;
          if (e < kc) Elem<T>::store_global(a.xd + at + e * sizeof(T), Elem<T>::load(from + e * sizeof(T)));
        }
      }
    }
  }
  cp_async_wait<0>();

  if (row < a.n) {
    char* zt = a.zt + row * a.ldw * static_cast<long long>(sizeof(T));
#pragma unroll
    for (int h = 0; h < HP; ++h) {
      if (h < a.cols) Elem<T>::store(zt + h * sizeof(T), acc_t[h]);
    }
    if (EVAL) {
      char* ze = a.ze + row * a.ldw * static_cast<long long>(sizeof(T));
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        if (h < a.cols) Elem<T>::store(ze + h * sizeof(T), acc_e[h]);
      }
    }
  }
}

// ---- the wide way -------------------------------------------------------------

// 32-bit words of shared memory a row's chunk takes: one more than the chunk's
// (the word below the row's first element, and an odd stride: no bank
// conflicts when each lane reads its own row).
template <class T>
__host__ __device__ constexpr int wide_row_words() {
  return kWideBk * static_cast<int>(sizeof(T)) / 4 + 1;
}

// W whole (F rows of kWideCols f32) and each warp's two stages of 32 rows.
__host__ __device__ inline long long wide_smem_bytes(int f, int item) {
  return 4LL * f * kWideCols + 4LL * kWideWarps * 2 * 32 * (kWideBk * item / 4 + 1);
}

// The warp's copy of a chunk of kc columns of `rows` rows into the stage at
// `xs`, `src` the first row's first element: each row's 4-byte words from the
// one below its first element, a lane a word.
template <class T>
__device__ __forceinline__ void wide_load(const Args& a, uint32_t xs, const char* src, int rows,
                                          int kc, int lane) {
  constexpr int kRowBytes = wide_row_words<T>() * 4;
  const long long row_bytes = static_cast<long long>(a.f) * sizeof(T);
  if constexpr (sizeof(T) == 4) {  // rows start on 4 bytes: kc words a row
    if (lane >= kc) return;
    src += 4 * lane;
    xs += 4 * lane;
#pragma unroll 4
    for (int i = 0; i < rows; ++i, src += row_bytes, xs += kRowBytes) cp_async4(xs, src, 4);
  } else {
#pragma unroll 4
    for (int i = 0; i < rows; ++i, src += row_bytes, xs += kRowBytes) {
      const int shift = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
      if (lane < (shift + kc * 2 + 3) >> 2) cp_async4(xs + 4 * lane, src - shift + 4 * lane, 4);
    }
  }
}

// The warp's xd of the chunk, from the stage at `xs` where its lanes wrote it
// over x, to `dst` (the first row's first element), the lanes along each row;
// `src` as for wide_load (the rows' byte shifts).
template <class T>
__device__ __forceinline__ void wide_store_xd(const Args& a, const char* xs, char* dst,
                                              const char* src, int rows, int kc, int lane) {
  constexpr int kRowBytes = wide_row_words<T>() * 4;
  const long long row_bytes = static_cast<long long>(a.f) * sizeof(T);
  if (lane >= kc) return;
  const int e = lane * static_cast<int>(sizeof(T));
  dst += e;
#pragma unroll 4
  for (int i = 0; i < rows; ++i, src += row_bytes, dst += row_bytes, xs += kRowBytes) {
    const int shift = sizeof(T) == 4 ? 0 : static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
    Elem<T>::store_global(dst, Elem<T>::load(xs + shift + e));
  }
}

// x / q correctly rounded in f32, by one multiply and no branch: x times
// rq = 1 / q in f64 is within 2^-51 of the quotient, and a quotient of two
// f32 values is never within 2^-49 of it from a midpoint between two f32
// values (nor on one): it rounds to f32 as x / q does, bit for bit.
__device__ __forceinline__ float div_by_q(float xv, double rq) {
  return __double2float_rn(static_cast<double>(xv) * rq);
}

// Four elements kk0.. of the lane's row in the chunk at `xrow`, kept where
// their `bits` say: first their xd, written over x (four chains side by
// side), then their terms in all kWideCols columns, W's rows broadcast from
// shared memory. TAIL: the chunk's kc columns end among them.
template <class T, bool EVAL, bool TAIL>
__device__ __forceinline__ void wide_quad(const Args& a, char* xrow, const float4* w4, int kk0,
                                          int kc, double rq, const uint32_t (&bits)[4],
                                          float* acc_t, float* acc_e) {
  constexpr int kItem = static_cast<int>(sizeof(T));
  float xv[4], xdv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const bool in = !TAIL || kk0 + c < kc;
    xv[c] = in ? Elem<T>::load(xrow + (kk0 + c) * kItem) : 0.0f;
    xdv[c] = bits[c] < a.thresh ? Elem<T>::round(div_by_q(xv[c], rq)) : 0.0f;
    if (in) Elem<T>::store_smem(xrow + (kk0 + c) * kItem, xdv[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (TAIL && kk0 + c >= kc) break;
    accumulate<kWideCols, EVAL>(xdv[c], xv[c], w4 + (kk0 + c) * (kWideCols / 4), acc_t, acc_e);
  }
}

// The lane's row over the chunk's kc columns. B 32: a unit is the 4 columns
// of one Philox call, drawn by the row's own lane. B 8: a call covers 8
// columns of the row pair (r, r + 16), lanes l and l + 16 of the warp; a unit
// is 16 columns, the lower lane draws its first 8, the upper lane the second,
// and each hands its draw to the other. Either way each call is drawn once,
// one unit ahead; `u` carries the draw of the chunk's first unit in and of
// the next chunk's out. TAIL: kc ends inside a unit.
template <class T, bool EVAL, bool TAIL, int B>
__device__ __forceinline__ void wide_chunk(const Args& a, char* xrow, const float4* w4,
                                           const Draw& d, double rq, long long row, int k0,
                                           int kc, int half, uint4& u, float* acc_t,
                                           float* acc_e) {
  constexpr int kUnit = B == 32 ? 4 : 16;
  const int units = (kc + kUnit - 1) / kUnit;
#pragma unroll 1
  for (int g = 0; g < units; ++g) {
    const int next = k0 + kUnit * (g + 1);  // past F: drawn, unused
    const uint4 u_next = draw_at(d, call_of<B>(a, row, B == 32 ? next : next + 8 * half));
    if constexpr (B == 32) {
      const uint32_t bits[4] = {u.x, u.y, u.z, u.w};
      wide_quad<T, EVAL, TAIL>(a, xrow, w4, 4 * g, kc, rq, bits, acc_t, acc_e);
    } else {
      const uint4 other = make_uint4(__shfl_xor_sync(0xffffffffu, u.x, 16),
                                     __shfl_xor_sync(0xffffffffu, u.y, 16),
                                     __shfl_xor_sync(0xffffffffu, u.z, 16),
                                     __shfl_xor_sync(0xffffffffu, u.w, 16));
      const uint4 first = half ? other : u, second = half ? u : other;
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        if (TAIL && 16 * g + 4 * qd >= kc) break;
        const uint4& v = qd < 2 ? first : second;
        uint32_t bits[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) bits[c] = bits_of<8>(v, half, 4 * (qd % 2) + c);
        wide_quad<T, EVAL, TAIL>(a, xrow, w4, 16 * g + 4 * qd, kc, rq, bits, acc_t, acc_e);
      }
    }
    u = u_next;
  }
}

// Two f32 values as bf16 in one word, the first in the lower half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A lane's row of one product, `cols` columns of the launch from `out`: by
// 16-byte stores where all kWideCols are the launch's and the row starts on
// 16 bytes.
template <class T>
__device__ __forceinline__ void wide_store_row(char* out, const float* acc, int cols) {
  if (cols == kWideCols && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < kWideCols / 4; ++j) {
        reinterpret_cast<float4*>(out)[j] =
            make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kWideCols / 8; ++j) {
        reinterpret_cast<uint4*>(out)[j] =
            make_uint4(bf16_pair(acc[8 * j], acc[8 * j + 1]), bf16_pair(acc[8 * j + 2], acc[8 * j + 3]),
                       bf16_pair(acc[8 * j + 4], acc[8 * j + 5]), bf16_pair(acc[8 * j + 6], acc[8 * j + 7]));
      }
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < kWideCols; ++h) {
    if (h < cols) Elem<T>::store(out + h * static_cast<int>(sizeof(T)), acc[h]);
  }
}

template <class T, bool EVAL, int B>
__global__ void __launch_bounds__(kWideThreads, 1) layer0_wide_kernel(const Args a) {
  constexpr int kStage = 32 * wide_row_words<T>() * 4;  // bytes of a stage
  constexpr int kItem = static_cast<int>(sizeof(T));
  constexpr int kE = EVAL ? kWideCols : 1;
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4;
  float* ws = reinterpret_cast<float*>(smem);
  char* stages = smem + 4LL * a.f * kWideCols + warp * 2 * kStage;
  const uint32_t xs = smem_addr(stages);
  const long long tiles = (a.n + 31) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWideWarps;
  const int chunks = (a.f + kWideBk - 1) / kWideBk;
  const long long row_bytes = static_cast<long long>(a.f) * kItem;

  // W whole, its columns past `cols` zero-filled; rounded to bf16 for bf16 x
  const int w_words = a.f * kWideCols;
  const uint32_t wdst = smem_addr(ws);
  for (int idx = threadIdx.x; idx < w_words; idx += kWideThreads) {
    const int k = idx / kWideCols, h = idx % kWideCols;
    const bool in = h < a.cols;
    cp_async4(wdst + idx * 4, in ? a.w + static_cast<long long>(k) * a.ldw + h : a.w, in ? 4 : 0);
  }
  cp_async_commit();
  // the warp's items are (tile, chunk) in order; the next one's copy runs under this one
  long long tile = static_cast<long long>(blockIdx.x) * kWideWarps + warp;
  int c = 0, s = 0;
  const auto rows_of = [&](long long t) { return static_cast<int>(min(32LL, a.n - 32 * t)); };
  if (tile < tiles) {
    wide_load<T>(a, xs, a.x + 32 * tile * row_bytes, rows_of(tile), min(kWideBk, a.f), lane);
  }
  cp_async_commit();
  cp_async_wait<1>();
  for (int idx = threadIdx.x; idx < w_words; idx += kWideThreads) round_w<T>(ws, idx);
  __syncthreads();
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  const Draw d = read_draw(a);
  const double rq = 1.0 / static_cast<double>(a.q);

  float acc_t[kWideCols], acc_e[kE];
  uint4 u = uint4{};
  char* xrow = nullptr;  // the lane's row in stage 0; stage 1 is kStage on
  while (tile < tiles) {
    const int k0 = c * kWideBk, kc = min(kWideBk, a.f - k0), rows = rows_of(tile);
    const long long row0 = 32 * tile, row = row0 + lane;
    int c_next = c + 1;
    long long tile_next = tile;
    if (c_next == chunks) c_next = 0, tile_next += stride;
    if (tile_next < tiles) {  // into stage 1 - s, stored out by the last item
      wide_load<T>(a, xs + (1 - s) * kStage,
                   a.x + 32 * tile_next * row_bytes + static_cast<long long>(c_next) * kWideBk * kItem,
                   rows_of(tile_next), min(kWideBk, a.f - c_next * kWideBk), lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    if (c == 0) {
#pragma unroll
      for (int h = 0; h < kWideCols; ++h) acc_t[h] = 0.0f;
#pragma unroll
      for (int h = 0; h < kE; ++h) acc_e[h] = 0.0f;
      u = draw_at(d, call_of<B>(a, row, B == 32 ? 0 : 8 * half));
      // the row's byte shift in its chunks' first words: the same in every chunk
      xrow = stages + lane * wide_row_words<T>() * 4 +
             static_cast<int>(reinterpret_cast<uintptr_t>(a.x + row * row_bytes) & 3);
    }
    char* const st = stages + s * kStage;
    const char* src = a.x + row0 * row_bytes + static_cast<long long>(k0) * kItem;
    if (kc == kWideBk) {
      wide_chunk<T, EVAL, false, B>(a, xrow + s * kStage, w4 + k0 * (kWideCols / 4), d, rq, row,
                                    k0, kc, half, u, acc_t, acc_e);
    } else {
      wide_chunk<T, EVAL, true, B>(a, xrow + s * kStage, w4 + k0 * (kWideCols / 4), d, rq, row,
                                   k0, kc, half, u, acc_t, acc_e);
    }
    __syncwarp();
    if (a.xd != nullptr) {
      wide_store_xd<T>(a, st, a.xd + row0 * row_bytes + static_cast<long long>(k0) * kItem, src,
                       rows, kc, lane);
    }
    __syncwarp();  // the stage is read out: the next copy may land in it
    if (c == chunks - 1 && row < a.n) {
      const long long at = row * a.ldw * static_cast<long long>(kItem);
      wide_store_row<T>(a.zt + at, acc_t, a.cols);
      if constexpr (EVAL) wide_store_row<T>(a.ze + at, acc_e, a.cols);
    }
    tile = tile_next;
    c = c_next;
    s = 1 - s;
  }
  cp_async_wait<0>();
}

// ---- launch -------------------------------------------------------------------

// The SMs of the current device: a persistent CTA each.
cudaError_t device_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

template <class T, bool EVAL, int B>
cudaError_t launch(const Args& a, int path, cudaStream_t stream) {
  if (path == 2) {
    auto kernel = layer0_wide_kernel<T, EVAL, B>;
    const long long smem = wide_smem_bytes(a.f, sizeof(T));
    if (smem > kSmemMax || reinterpret_cast<uintptr_t>(a.x) % 16) return cudaErrorInvalidValue;
    int sms = 0;
    cudaError_t err = device_sms(&sms);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return err;
    const long long blocks = ((a.n + 31) / 32 + kWideWarps - 1) / kWideWarps;
    kernel<<<static_cast<unsigned>(min(blocks, static_cast<long long>(sms))), kWideThreads,
             static_cast<int>(smem), stream>>>(a);
    return cudaGetLastError();
  }
  if (path == 1) {
    auto kernel = layer0_flat_kernel<T, EVAL, B>;
    const long long smem = flat_smem_bytes(a.f, sizeof(T), EVAL);
    if (smem > kSmemMax || reinterpret_cast<uintptr_t>(a.x) % 16 ||
        reinterpret_cast<uintptr_t>(a.xd) % 16) {
      return cudaErrorInvalidValue;
    }
    int sms = 0;
    cudaError_t err = device_sms(&sms);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return err;
    const long long blocks = (a.n + 31) / 32;
    kernel<<<static_cast<unsigned>(min(blocks, static_cast<long long>(sms))), kFlatThreads + 32,
             static_cast<int>(smem), stream>>>(a);
    return cudaGetLastError();
  }
  auto kernel = layer0_pair_kernel<T, EVAL, B>;
  const int smem = kStages * stage_bytes<T>();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (a.n + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T, int B>
cudaError_t by_eval(const Args& a, int path, cudaStream_t stream) {
  return a.ze != nullptr ? launch<T, true, B>(a, path, stream) : launch<T, false, B>(a, path, stream);
}

template <class T>
cudaError_t by_bits(const Args& a, int path, int bits, cudaStream_t stream) {
  switch (bits) {
    case 8: return by_eval<T, 8>(a, path, stream);
    case 32: return by_eval<T, 32>(a, path, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch over the output columns [h_off, h_off + cols) of x @ W (the
// launch's W columns past cols zero-filled) by the way kernels.layer0_path
// chose: `path` 0 the chunked way or 1 the flat way (cols at most 16), 2 the
// wide way (cols at most 64); `write_xd` in exactly one of a call's launches.
// An element is kept where its `bits` (8 or 32) of the uniforms read below
// `thresh` (kernels.dropout_keep). `dtype` is 0 for f32 x, 1 for bf16 x; W is
// f32 [f, h]; zt and ze (ze null: the train half only) are [n, h] of x's type.
extern "C" int layer0_pair(const void* x, const void* w, const void* seeds, void* xd, void* zt,
                           void* ze, long long n, int f, int h, int h_off, int cols, int path, float q, float inv_q, int q_pow2, unsigned thresh, int bits,
                           int write_xd, int dtype, void* stream) {
  if (n <= 0 || f <= 0 || cols <= 0 || path < 0 || path > 2 ||
      cols > (path == 2 ? kWideCols : kWidth) || (n + kRows - 1) / kRows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int item = dtype == 1 ? 2 : 4;
  Args a;
  a.x = static_cast<const char*>(x);
  a.w = static_cast<const float*>(w) + h_off;
  a.seeds = static_cast<const long long*>(seeds);
  a.xd = write_xd ? static_cast<char*>(xd) : nullptr;
  a.zt = static_cast<char*>(zt) + static_cast<long long>(h_off) * item;
  a.ze = ze != nullptr ? static_cast<char*>(ze) + static_cast<long long>(h_off) * item : nullptr;
  a.n = n;
  a.f = f;
  a.ldw = h;
  a.cols = cols;
  a.q = q;
  a.inv_q = inv_q;
  a.q_pow2 = q_pow2;
  a.thresh = thresh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = by_bits<float>(a, path, bits, s); break;
    case 1: err = by_bits<bf16>(a, path, bits, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
