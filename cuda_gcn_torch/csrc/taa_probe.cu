// Probe kernels of the take-along-axis family: element gathers along either
// axis of a table, a column scan, and the gather -> scale -> scan -> boundary
// difference "piece" that expresses a sorted segment sum without a scatter.
//
//   taa_rows:    out[i, j] = sum_{r < reps} sum_{k < steps} tab[idx(i, j, k), j]
//   taa_lanes:   out[i, j] = sum_{r < reps} sum_{k < steps} tab[i, idx(i, j, k)]
//   cumsum_cols: out[i, j] = sum_{r < reps} cs[i, j],   cs = cumsum(tab, axis 0)
//   piece:       vals[i, :] = tab[ids[i], :] * coef[i];  cs = [0; cumsum(vals, 0)]
//                out[i, j] = sum_{r < reps} (cs[end[i], j] - cs[begin[i], j])
//
// idx(i, j, k) = idx[i * si + j * sj + k * sk]: one index array with three
// element strides, a stride of 0 being a broadcast. That one form covers a full
// index array (a different source per element), a compact [S, steps] or
// [steps, L] array (a whole row or column per step) and a single index per row.
//
// They replace the TPU probe bodies taa_kernel, cumsum_kernel and piece_kernel
// (scripts/exp_pallas_taa.py:77,98,117), sublane_kernel and lane_kernel
// (scripts/exp_dyngather.py:38,54), k1..k5 (scripts/exp_dyngather2.py:53-101)
// and try_taa's body (scripts/exp_dyngather3.py:27). Those measured which
// forms of an in-VMEM dynamic gather the TPU compiler lowers and at what rate;
// on the card every form runs, from device memory and L2.
//
// taa_rows moves few bytes (at [8192, 128] f32 one step reads and writes 8 MB,
// 2.5 us at the card's rate), so a launch is bound by the number of load
// instructions it takes to cover the table, and by the latency of a chain of
// dependent loads (index, then row) for every step. The launcher picks one of
// two forms from the strides (kernels.taa_rows_form):
// * row form, sj == 0: one index gives a whole row. A thread takes 4
//   neighbouring columns, 16 bytes of a f32 row or 8 of a bf16 row, so a warp
//   reads 512 contiguous bytes of one table row with one instruction and
//   stores its 4 sums with one. The index is the same address for the threads
//   of a row (one broadcast load per row and step). The steps go in whole
//   batches of 8 whose row loads are all in flight before the first is added,
//   then one by one. A thread id splits into (row, column group) in 32 bits,
//   by a shift when the row has a power-of-two number of groups.
// * the general form: one thread per output element, any strides, 64-bit
//   offsets. A full index (a different row per element) stays here: its loads
//   are 4 scattered bytes each whatever a thread is given, and 4 elements a
//   thread with one 16-byte index load measured level on one step and slower
//   on the repeated small shapes, where fewer threads walk the same chain.
// taa_lanes reads the table row of each output element at columns that the
// index names, so every (element, step) is a dependent pair: an index load,
// then a read of the row. Its bytes bound (idx, the table and out once: 3.1 us
// at [128, 8192] f32 x64 steps) is far below what the reads of the rows take
// from shared memory, 4 bytes an element and step (268 MB at that shape, 9 us
// at the SMs' 128 bytes a clock with no bank conflict), so the design cuts the
// index traffic and spends shared-memory reads as vectors. The launcher picks
// one of two forms (kernels.taa_lanes_form):
// * group form, si == 0 (the index does not depend on the row: the compact
//   [steps, L] layouts of exp_dyngather.py's lane_kernel): a CTA of 512
//   threads takes a group of R table rows and a tile of columns, and stages
//   the R rows transposed, [L][R] in shared memory, so the R values of one
//   column are 4, 8 or 16 contiguous bytes, W words (R = 2, 4, 8 bf16 or 1,
//   2, 4 f32; the stage within a block's 232,448 bytes). Staging reads each
//   row with 16-byte loads, 8 in flight a thread, transposes them in
//   registers and stores whole columns, swizzled so that a warp's stores hit
//   distinct banks (stage_pos). Then a thread takes a column and keeps R
//   sums: each index is loaded once and serves the R rows with one vector
//   read of the stage. That divides the index traffic by R (at [128, 8192]
//   f32, 256 MB read row after row becomes 64 MB) and spends a shared-memory
//   wavefront on up to 8 random columns of R values where a scalar read
//   spends it on fewer values. The steps go in batches of 16 whose index
//   loads are all in flight before the first read. The launcher sizes the
//   column tile so that groups x tiles fill the card's SMs about once, and
//   takes the R whose stages (read from L2 once a tile) and index loads
//   (once a group) move the fewest bytes.
// * general form, any strides (a full index: k4 and exp_dyngather3.py's axis
//   1): a CTA stages its one table row in shared memory (above 48 KB by
//   opt-in; a row that does not fit is read from global memory) and walks a
//   tile of 1024 columns, an index load and a row read a step.
// In all of them, the sum starts at 0 and adds step after step, rep after rep,
// in f32, and every rep reads the table again (a compiler barrier keeps the
// loads inside the loop): the probes time gathers, not additions.
//
// cumsum_cols and piece are one cooperative launch each, of one scan body
// (scan_kernel). The table is cut into tiles of 128 rows (a chunk) by 128
// columns; a CTA of 16 warps takes a tile, each warp 8 rows, each lane 4
// columns (one 16-byte load a row where L % 4 == 0 and the pointers are
// 16-byte aligned, else 4 values a warp apart). The tile's values are read
// once, all of a warp's loads in flight together, and stay in registers until
// they are written: each warp scans its 8 rows, the warp totals go through
// shared memory and give each warp its offset within the chunk, and the
// chunk's total is published to a scratch array. One grid-wide barrier; then
// every CTA reads the totals of the chunks before its own in one round trip
// into shared memory, adds them up and writes. The order of additions is
// fixed and does not depend on the grid: row after row within a warp, warp
// totals in order, and the chunk totals as one left fold from 0
// (probes.taa.scan_order_plain restates it). No atomics: the same bits on
// every run. The grid holds what the card keeps resident (occupancy times
// SMs, 128 CTAs at the probes' [16384, 128]); a larger table goes in waves of
// that many tiles, each wave with its barrier, and the fold's running value
// crosses from one wave to the next through two scratch rows a column tile,
// used in turns. Rows are ints and chunks times column tiles below 2^31. The
// scan is taken once per launch and the last addition repeated `reps` times
// in order, all of a thread's values side by side so that the additions do
// not wait on each other; for finite inputs that is what the TPU loops
// compute (cumsum_kernel's `tab + acc * 0` only differs when acc holds an
// infinity or a NaN, and that is not reproduced). piece gathers its rows in
// the same single read (tab[ids[i]] * coef[i], the product rounded apart from
// the sums), writes the scan with a leading zero row into an [S+1, L] scratch
// (L2 holds it at the probes' 8 MB), and after one more grid barrier the same
// launch reads the two boundary rows of each output row, 8 rows in flight a
// warp; begin and end may be any values in [0, S], in any order. A launch
// that the card refuses returns its error; nothing falls back. What is left
// above the bytes bound: the whole table is read before any of it is written
// (the barrier between), and piece reads its scan back from L2.
//
// Bound on the H100: bytes for all four (each input read once, out written
// once); the gathers are served mostly from L2.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLaneTile = 1024;           // columns per CTA of taa_lanes
constexpr int kMaxStageBytes = 200 << 10; // largest table row staged in shared memory
constexpr int kScanWarps = 16;                     // warps a scan CTA
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kWarpRows = 8;                       // rows a warp scans in registers
constexpr int kScanRows = kScanWarps * kWarpRows;  // rows a chunk (kernels.SCAN_CHUNK_ROWS)
constexpr int kScanCols = 128;                     // columns a tile, 4 a lane (SCAN_TILE_COLS)
constexpr int kFoldChunks = 128;                   // chunk totals staged at once for the fold
constexpr int kStageBytes = kFoldChunks * kScanCols * 4;  // dynamic shared memory
constexpr int kDiffBatch = 8;                      // piece: boundary rows in flight a warp
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 4 neighbouring table values as f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);  // a bf16 is the high half of its f32
  v[0] = __uint_as_float(t.x << 16), v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16), v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// thread t of the row form -> (row i, first column j) of its 4 outputs, which
// are out[4 * t ..]; groups = l / 4, shift = log2(groups) or -1
__device__ __forceinline__ void split_thread(unsigned t, int groups, int shift, unsigned& i,
                                             unsigned& j) {
  i = shift >= 0 ? t >> shift : t / (unsigned)groups;
  j = 4u * (t - i * (unsigned)groups);
}

constexpr int kRowBatch = 8;  // row loads in flight per thread of the row form

// general form: one thread per output element, any strides
template <class T>
__global__ void __launch_bounds__(kThreads)
taa_rows_kernel(const int* idx, int64_t si, int64_t sj, int64_t sk, const T* tab,
                float* __restrict__ out, int l, int steps, int reps, int64_t total) {
  const int64_t t = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t i = t / l;
  const int j = (int)(t - i * l);
  const int* ip = idx + i * si + j * sj;
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
#pragma unroll 4
    for (int k = 0; k < steps; ++k) acc += to_float(tab[(int64_t)ip[k * sk] * l + j]);
    asm volatile("" ::: "memory");
  }
  out[t] = acc;
}

// row form (sj == 0, l % 4 == 0, S * L < 2^31): out[i, j..j+3] from whole rows
template <class T>
__global__ void __launch_bounds__(kThreads)
taa_rows_row_kernel(const int* idx, int64_t si, int sk, const T* tab, float* __restrict__ out,
                    int l, int shift, int steps, int reps, unsigned total) {
  const unsigned t = blockIdx.x * (unsigned)kThreads + threadIdx.x;
  if (t >= total) return;
  unsigned i, j;
  split_thread(t, l >> 2, shift, i, j);
  const int* ip = idx + i * si;
  const T* col = tab + j;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const unsigned ul = (unsigned)l;
  for (int r = 0; r < reps; ++r) {
    int k = 0;
    for (; k + kRowBatch <= steps; k += kRowBatch) {  // whole batches: all loads, then all adds
      int id[kRowBatch];
      float v[kRowBatch][4];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) id[u] = ip[(k + u) * sk];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) load4(col + (unsigned)id[u] * ul, v[u]);
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += v[u][c];
    }
    for (; k < steps; ++k) {
      float v[4];
      load4(col + (unsigned)ip[k * sk] * ul, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] += v[c];
    }
    asm volatile("" ::: "memory");
  }
  reinterpret_cast<float4*>(out)[t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
taa_lanes_kernel(const int* idx, int64_t si, int64_t sj, int64_t sk, const T* tab,
                 float* __restrict__ out, int l, int steps, int reps, int staged) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int i = blockIdx.y;
  const T* row = tab + (int64_t)i * l;
  if (staged) {
    T* srow = reinterpret_cast<T*>(stage);
    for (int c = threadIdx.x; c < l; c += kThreads) srow[c] = row[c];
    __syncthreads();
    row = srow;
  }
  const int j0 = blockIdx.x * kLaneTile;
  const int j1 = min(l, j0 + kLaneTile);
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    const int* ip = idx + i * si + j * sj;
    float acc = 0.f;
    for (int r = 0; r < reps; ++r) {
#pragma unroll 4
      for (int k = 0; k < steps; ++k) acc += to_float(row[ip[k * sk]]);
      asm volatile("" ::: "memory");
    }
    out[(int64_t)i * l + j] = acc;
  }
}

// W 32-bit words of a staged column: one load from shared memory
template <int W> struct Words;
template <> struct Words<1> {
  using V = unsigned;
  __device__ static V make(const unsigned (&w)[1]) { return w[0]; }
  __device__ static void get(V v, unsigned (&w)[1]) { w[0] = v; }
};
template <> struct Words<2> {
  using V = uint2;
  __device__ static V make(const unsigned (&w)[2]) { return make_uint2(w[0], w[1]); }
  __device__ static void get(V v, unsigned (&w)[2]) { w[0] = v.x, w[1] = v.y; }
};
template <> struct Words<4> {
  using V = uint4;
  __device__ static V make(const unsigned (&w)[4]) { return make_uint4(w[0], w[1], w[2], w[3]); }
  __device__ static void get(V v, unsigned (&w)[4]) { w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w; }
};

// the R table values of a staged column of W words (one f32 row or two bf16
// rows a word, the even row in the low half), added to their sums in row order
template <int kItem, int W>
__device__ __forceinline__ void add_words(typename Words<W>::V v, float (&acc)[W * 4 / kItem]) {
  unsigned w[W];
  Words<W>::get(v, w);
#pragma unroll
  for (int q = 0; q < W * 4 / kItem; ++q) {
    const unsigned word = w[q * kItem / 4];
    acc[q] += __uint_as_float(kItem == 4 ? word : (q & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

constexpr int kGroupThreads = 512;  // threads a CTA of the group form
constexpr int kGroupBatch = 16;     // index loads in flight per thread of the group form

// where column c of a group is staged: c ^ ((c / V) mod N), V the columns of a
// 16-byte row load, N the staged columns of one 128-byte shared-memory
// wavefront. Consecutive threads store column cc of consecutive 16-byte loads,
// which the swizzle puts in distinct banks; it changes only the low bits of c
// within an aligned run of N, so the stage holds l rounded up to N columns.
template <int kItem, int W>
__device__ __forceinline__ unsigned stage_pos(unsigned c) {
  constexpr unsigned V = 16 / kItem, N = 32 / W;
  return c ^ ((c / V) & (N - 1));
}

__device__ __forceinline__ unsigned word_of(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// word j of staged column cc, from the 16-byte loads in[q] of the group's R
// rows at the same columns: an f32 row per word, or two bf16 rows (the even
// row in the low half)
template <int kItem, int R>
__device__ __forceinline__ unsigned column_word(const uint4 (&in)[R], int cc, int j) {
  if constexpr (kItem == 4) {
    return word_of(in[j], cc);
  } else {
    return __byte_perm(word_of(in[2 * j], cc >> 1), word_of(in[2 * j + 1], cc >> 1),
                       (cc & 1) ? 0x7632 : 0x5410);
  }
}

// group form (si == 0): out[i0 + q, j] for the R = 4 W / kItem rows of group
// blockIdx.y and the columns of tile blockIdx.x, table values of kItem bytes
// (2: bf16, 4: f32). The group's rows are staged transposed, W words a column:
// with `vec` (rows a whole number of 16-byte loads) each thread loads 16 bytes
// of each row, 8 loads in flight, and transposes them in registers; else one
// value at a time. A thread then takes a column of the tile: each index it
// loads serves its R sums through one vector read of the stage.
template <int kItem, int W>
__global__ void __launch_bounds__(kGroupThreads)
taa_lanes_group_kernel(const int* __restrict__ idx, int sj, int sk, const void* __restrict__ tab_v,
                       float* __restrict__ out, int s, int l, int steps, int reps, int tile,
                       int vec) {
  constexpr int R = 4 * W / kItem, V = 16 / kItem, kBatch = R >= 8 ? 1 : 8 / R;
  using Vec = typename Words<W>::V;
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  Vec* stage = reinterpret_cast<Vec*>(stage_bytes);
  const unsigned char* tab = static_cast<const unsigned char*>(tab_v);
  const int i0 = blockIdx.y * R;
  const int nt = blockDim.x;
  if (vec) {
    const int groups = l / V;
    for (int g0 = threadIdx.x; g0 < groups; g0 += nt * kBatch) {
      uint4 in[kBatch][R];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int g = g0 + b * nt;
#pragma unroll
        for (int q = 0; q < R; ++q)
          in[b][q] = g < groups && i0 + q < s
                         ? __ldg(reinterpret_cast<const uint4*>(tab + (size_t)(i0 + q) * l * kItem) + g)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int g = g0 + b * nt;
        if (g < groups) {
#pragma unroll
          for (int cc = 0; cc < V; ++cc) {
            unsigned w[W];
#pragma unroll
            for (int j = 0; j < W; ++j) w[j] = column_word<kItem>(in[b], cc, j);
            stage[stage_pos<kItem, W>(g * V + cc)] = Words<W>::make(w);
          }
        }
      }
    }
  } else {
    using Raw = std::conditional_t<kItem == 2, unsigned short, unsigned>;
    const Raw* rows = reinterpret_cast<const Raw*>(tab);
    for (int c = threadIdx.x; c < l; c += nt) {
      unsigned w[W];
#pragma unroll
      for (int u = 0; u < W; ++u) w[u] = 0u;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const unsigned bits = i0 + q < s ? (unsigned)rows[(size_t)(i0 + q) * l + c] : 0u;
        w[q * kItem / 4] |= bits << (8 * (q * kItem % 4));
      }
      stage[stage_pos<kItem, W>(c)] = Words<W>::make(w);
    }
  }
  __syncthreads();
  const int j0 = blockIdx.x * tile;
  const int j1 = min(l, j0 + tile);
  for (int j = j0 + threadIdx.x; j < j1; j += nt) {
    const int* ip = idx + j * sj;
    float acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = 0.f;
    for (int r = 0; r < reps; ++r) {
      int k = 0;
      for (; k + kGroupBatch <= steps; k += kGroupBatch) {  // all index loads, then the reads
        int id[kGroupBatch];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u) id[u] = ip[(k + u) * sk];
#pragma unroll
        for (int u = 0; u < kGroupBatch; ++u)
          add_words<kItem, W>(stage[stage_pos<kItem, W>(id[u])], acc);
      }
      for (; k < steps; ++k) add_words<kItem, W>(stage[stage_pos<kItem, W>(ip[k * sk])], acc);
      asm volatile("" ::: "memory");
    }
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (i0 + q < s) out[(size_t)(i0 + q) * l + j] = acc[q];
  }
}

// what a scan launch reads and writes; totals is scratch: [col_tiles][chunks]
// rows of kScanCols chunk totals, then [2][col_tiles] rows of the fold's
// running value between waves
struct ScanParams {
  const float* tab;
  const int* ids;     // piece: the gathered rows, their scales and boundaries
  const float* coef;
  const int* begin;
  const int* end;
  float* out;         // [s, l]
  float* cs;          // piece: [s + 1, l], the scan after a zero row
  float* totals;
  int s, l, chunks, col_tiles, reps;
};

// the column of its tile that value k of a lane holds: 4 neighbours (one
// 16-byte load) or 4 columns a warp apart (one value at a time)
template <bool kVec>
__device__ __forceinline__ int lane_col(int lane, int k) {
  return kVec ? 4 * lane + k : lane + 32 * k;
}

// a lane's 4 values of a row of a tile that has ncols columns (0 past them);
// kL2: data written earlier in the same launch, read through L2 only
template <bool kVec, bool kL2>
__device__ __forceinline__ void load_cols(const float* row, int ncols, int lane, float (&x)[4]) {
  if constexpr (kVec) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * lane < ncols) {
      const float4* at = reinterpret_cast<const float4*>(row) + lane;
      t = kL2 ? __ldcg(at) : __ldg(at);
    }
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = lane + 32 * k;
      x[k] = c < ncols ? (kL2 ? __ldcg(row + c) : __ldg(row + c)) : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_cols(float* row, int ncols, int lane, const float (&x)[4]) {
  if constexpr (kVec) {
    if (4 * lane < ncols) reinterpret_cast<float4*>(row)[lane] = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < ncols) row[lane + 32 * k] = x[k];
  }
}

// x[n][4] -> reps additions of each value from 0, in order; the n * 4 chains
// go side by side, one addition of each a step
template <int N>
__device__ __forceinline__ void repeat_add(float (&x)[N][4], int reps) {
  float acc[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
  for (int r = 0; r < reps; ++r)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[n][k] += x[n][k];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) x[n][k] = acc[n][k];
}

// cumsum_cols (kPiece false): out = reps additions of the inclusive scan of
// tab; piece: cs = [0; scan of tab[ids] * coef], then out = reps additions of
// cs[end] - cs[begin]. Tile t is (column tile t / chunks, chunk t % chunks);
// wave w takes tiles w * gridDim.x + blockIdx.x.
template <bool kPiece, bool kVec>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const ScanParams p) {
  __shared__ float warp_tot[kScanWarps][kScanCols];  // each warp's total
  __shared__ float warp_off[kScanWarps][kScanCols];  // the totals of the warps before it
  __shared__ float chunk_tot[kScanCols], chunk_off[kScanCols];
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  float* stage = reinterpret_cast<float*>(stage_bytes);  // [kFoldChunks][kScanCols] totals
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int tiles = p.chunks * p.col_tiles, nb = gridDim.x;
  const int waves = (tiles + nb - 1) / nb;
  float* run = p.totals + (size_t)tiles * kScanCols;
  for (int w = 0; w < waves; ++w) {
    const int t = w * nb + blockIdx.x;
    const bool live = t < tiles;  // the same for the whole CTA
    const int ct = live ? t / p.chunks : 0;
    const int c = t - ct * p.chunks;
    const int ncols = p.l - ct * kScanCols;
    const int r0 = c * kScanRows + warp * kWarpRows;
    float v[kWarpRows][4];
    if (live) {
      // the warp's rows (for piece, lane u reads row u's id and scale): every
      // load in flight before the first addition
      int id = -1;
      float coef = 0.f;
      if (kPiece && lane < kWarpRows && r0 + lane < p.s) {
        id = __ldg(p.ids + r0 + lane);
        coef = __ldg(p.coef + r0 + lane);
      }
      int src[kWarpRows];
      float scale[kWarpRows];
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
        src[u] = kPiece ? __shfl_sync(~0u, id, u) : r0 + u < p.s ? r0 + u : -1;
        scale[u] = kPiece ? __shfl_sync(~0u, coef, u) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
        if (src[u] >= 0) {
          load_cols<kVec, false>(p.tab + (size_t)src[u] * p.l + ct * kScanCols, ncols, lane, v[u]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) v[u][k] = 0.f;
        }
      }
      if constexpr (kPiece) {
#pragma unroll
        for (int u = 0; u < kWarpRows; ++u)
#pragma unroll
          for (int k = 0; k < 4; ++k) v[u][k] = __fmul_rn(v[u][k], scale[u]);
      }
#pragma unroll
      for (int u = 1; u < kWarpRows; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) v[u][k] = v[u - 1][k] + v[u][k];
#pragma unroll
      for (int k = 0; k < 4; ++k) warp_tot[warp][lane_col<kVec>(lane, k)] = v[kWarpRows - 1][k];
      __syncthreads();
      if (tid < kScanCols) {
        float acc = warp_tot[0][tid];
#pragma unroll
        for (int q = 1; q < kScanWarps; ++q) {
          warp_off[q][tid] = acc;
          acc = acc + warp_tot[q][tid];
        }
        chunk_tot[tid] = acc;
        __stcg(p.totals + (size_t)t * kScanCols + tid, acc);
      }
      __syncthreads();
      if (warp > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float off = warp_off[warp][lane_col<kVec>(lane, k)];
#pragma unroll
          for (int u = 0; u < kWarpRows; ++u) v[u][k] = off + v[u][k];
        }
      }
    }
    grid.sync();
    if (live) {
      // the chunk's offset: the fold up to the tile's first chunk in this wave
      // (0, or what the wave before left), then the totals of the chunks
      // between it and this one, in order
      const int first = max(w * nb, ct * p.chunks) - ct * p.chunks;
      float off = 0.f;
      if (tid < kScanCols && first > 0)
        off = __ldcg(run + ((size_t)((w - 1) & 1) * p.col_tiles + ct) * kScanCols + tid);
      for (int c0 = first; c0 < c; c0 += kFoldChunks) {
        const int m = min(kFoldChunks, c - c0);
        const float4* from =
            reinterpret_cast<const float4*>(p.totals + ((size_t)ct * p.chunks + c0) * kScanCols);
        float4* to = reinterpret_cast<float4*>(stage);
        float4 in[kStageBytes / 16 / kScanThreads];
#pragma unroll
        for (int q = 0; q < kStageBytes / 16 / kScanThreads; ++q) {
          const int e = tid + q * kScanThreads;
          if (e < m * (kScanCols / 4)) in[q] = __ldcg(from + e);
        }
#pragma unroll
        for (int q = 0; q < kStageBytes / 16 / kScanThreads; ++q) {
          const int e = tid + q * kScanThreads;
          if (e < m * (kScanCols / 4)) to[e] = in[q];
        }
        __syncthreads();
        if (tid < kScanCols) {
          int q = 0;
#pragma unroll 8
          for (; q < m; ++q) off = off + stage[q * kScanCols + tid];
        }
        __syncthreads();
      }
      if (tid < kScanCols) {
        chunk_off[tid] = off;
        if (c + 1 < p.chunks && t + 1 == (w + 1) * nb)  // the wave ends inside the column tile
          __stcg(run + ((size_t)(w & 1) * p.col_tiles + ct) * kScanCols + tid, off + chunk_tot[tid]);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float off = chunk_off[lane_col<kVec>(lane, k)];
#pragma unroll
        for (int u = 0; u < kWarpRows; ++u) v[u][k] = off + v[u][k];
      }
      if (!kPiece) repeat_add(v, p.reps);
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
        const int row = r0 + u;
        if (row >= p.s) break;
        float* dst = (kPiece ? p.cs + (size_t)(row + 1) * p.l : p.out + (size_t)row * p.l) +
                     ct * kScanCols;
        store_cols<kVec>(dst, ncols, lane, v[u]);
      }
      if (kPiece && c == 0 && warp == 0) {
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
        store_cols<kVec>(p.cs + ct * kScanCols, ncols, lane, zero);
      }
    }
  }
  if constexpr (kPiece) {
    grid.sync();
    // out[i] = reps additions of cs[end[i]] - cs[begin[i]]: each warp a
    // contiguous run of (row, column tile) items; lane q reads the row and
    // boundaries of item q of each 32, then kDiffBatch items' rows are in
    // flight at once
    const long long items = (long long)p.s * p.col_tiles;
    const long long warps = (long long)nb * kScanWarps;
    const long long per = (items + warps - 1) / warps;
    const long long i0 = ((long long)blockIdx.x * kScanWarps + warp) * per;
    const long long i1 = min(items, i0 + per);
    for (long long g0 = i0; g0 < i1; g0 += 32) {
      int my_row = -1, my_ct = 0, my_e = 0, my_b = 0;
      if (g0 + lane < i1) {
        my_row = (int)((g0 + lane) / p.col_tiles);
        my_ct = (int)(g0 + lane - (long long)my_row * p.col_tiles);
        my_e = __ldg(p.end + my_row);
        my_b = __ldg(p.begin + my_row);
      }
      const int n = (int)min(32LL, i1 - g0);
      for (int q0 = 0; q0 < n; q0 += kDiffBatch) {
        int row[kDiffBatch], cti[kDiffBatch];
        float d[kDiffBatch][4], lo[kDiffBatch][4];
#pragma unroll
        for (int q = 0; q < kDiffBatch; ++q) {
          row[q] = __shfl_sync(~0u, my_row, q0 + q);
          cti[q] = __shfl_sync(~0u, my_ct, q0 + q);
          const int e = __shfl_sync(~0u, my_e, q0 + q), b = __shfl_sync(~0u, my_b, q0 + q);
          if (row[q] < 0) continue;
          const int nc = p.l - cti[q] * kScanCols;
          const float* base = p.cs + cti[q] * kScanCols;
          load_cols<kVec, true>(base + (size_t)e * p.l, nc, lane, d[q]);
          load_cols<kVec, true>(base + (size_t)b * p.l, nc, lane, lo[q]);
        }
#pragma unroll
        for (int q = 0; q < kDiffBatch; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) d[q][k] = d[q][k] - lo[q][k];
        repeat_add(d, p.reps);
#pragma unroll
        for (int q = 0; q < kDiffBatch; ++q)
          if (row[q] >= 0)
            store_cols<kVec>(p.out + (size_t)row[q] * p.l + cti[q] * kScanCols,
                             p.l - cti[q] * kScanCols, lane, d[q]);
      }
    }
  }
}
constexpr int kFormGeneral = 0, kFormRow = 1;  // kernels.TAA_FORMS

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <class T>
cudaError_t launch_rows(int form, const int* idx, int64_t si, int64_t sj, int64_t sk,
                        const void* tab_v, float* out, int s, int l, int steps, int reps,
                        cudaStream_t stream) {
  const T* tab = static_cast<const T*>(tab_v);
  const int64_t total = (int64_t)s * l;
  if (form == kFormGeneral) {
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    taa_rows_kernel<T><<<blocks, kThreads, 0, stream>>>(idx, si, sj, sk, tab, out, l, steps,
                                                        reps, total);
    return cudaGetLastError();
  }
  // what the row form rests on; the launcher chose the form by the same rules,
  // so a refusal here is a fault of the caller
  if (form != kFormRow || sj != 0 || l % 4 != 0 || total >= (int64_t(1) << 31) ||
      (steps - 1) * sk >= (int64_t(1) << 31) || !aligned(tab, 4 * (int)sizeof(T)) ||
      !aligned(out, 16))
    return cudaErrorInvalidValue;
  const int groups = l / 4;
  const int shift = (groups & (groups - 1)) == 0 ? __builtin_ctz(groups) : -1;
  const unsigned threads = (unsigned)(total / 4);
  taa_rows_row_kernel<T><<<(threads + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      idx, si, (int)sk, tab, out, l, shift, steps, reps, threads);
  return cudaGetLastError();
}

// the group form's shared memory: l columns rounded up to a swizzle run, W words each
int group_stage_bytes(int l, int w) {
  const int n = 32 / w;
  return (l + n - 1) / n * n * w * 4;
}

template <int kItem, int W>
cudaError_t launch_lanes_group(const int* idx, int sj, int sk, const void* tab, float* out,
                               int s, int l, int steps, int reps, int tile,
                               cudaStream_t stream) {
  constexpr int R = 4 * W / kItem;
  const int smem = group_stage_bytes(l, W);
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(taa_lanes_group_kernel<kItem, W>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return err;
  }
  const int vec = l % (16 / kItem) == 0 && aligned(tab, 16);
  const dim3 grid((l + tile - 1) / tile, (s + R - 1) / R);
  taa_lanes_group_kernel<kItem, W><<<grid, kGroupThreads, smem, stream>>>(
      idx, sj, sk, tab, out, s, l, steps, reps, tile, vec);
  return cudaGetLastError();
}

constexpr int kLanesGeneral = 0, kLanesGroup = 1;  // kernels.TAA_LANES_FORMS

// the group form's R rows a group, by the table's type; what it rests on is
// checked here too: the launcher chose the form by the same rules, so a
// refusal is a fault of the caller
cudaError_t launch_group(const int* idx, int64_t si, int64_t sj, int64_t sk, const void* tab,
                         int bf16, float* out, int s, int l, int steps, int reps, int rows,
                         int tile, cudaStream_t stream) {
  const int64_t span = (l - 1) * sj + (steps - 1) * sk;
  const int item = bf16 ? 2 : 4;
  if (si != 0 || span >= (int64_t(1) << 31) || tile < 1 || rows * item < 4 ||
      rows * item > 16 || group_stage_bytes(l, rows * item / 4) > 232448)
    return cudaErrorInvalidValue;
  const int i_sj = (int)sj, i_sk = (int)sk;
  switch (rows * item) {
    case 4:
      return bf16 ? launch_lanes_group<2, 1>(idx, i_sj, i_sk, tab, out, s, l, steps, reps, tile, stream)
                  : launch_lanes_group<4, 1>(idx, i_sj, i_sk, tab, out, s, l, steps, reps, tile, stream);
    case 8:
      return bf16 ? launch_lanes_group<2, 2>(idx, i_sj, i_sk, tab, out, s, l, steps, reps, tile, stream)
                  : launch_lanes_group<4, 2>(idx, i_sj, i_sk, tab, out, s, l, steps, reps, tile, stream);
    case 16:
      return bf16 ? launch_lanes_group<2, 4>(idx, i_sj, i_sk, tab, out, s, l, steps, reps, tile, stream)
                  : launch_lanes_group<4, 4>(idx, i_sj, i_sk, tab, out, s, l, steps, reps, tile, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class T>
cudaError_t launch_lanes(const int* idx, int64_t si, int64_t sj, int64_t sk, const void* tab,
                         float* out, int s, int l, int steps, int reps,
                         cudaStream_t stream) {
  const size_t row_bytes = (size_t)l * sizeof(T);
  const int staged = row_bytes <= (size_t)kMaxStageBytes;
  const size_t smem = staged ? row_bytes : 0;
  if (smem > (48u << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        taa_lanes_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((l + kLaneTile - 1) / kLaneTile, s);
  taa_lanes_kernel<T><<<grid, kThreads, smem, stream>>>(
      idx, si, sj, sk, static_cast<const T*>(tab), out, l, steps, reps, staged);
  return cudaGetLastError();
}

// one cooperative launch of the scan: as many CTAs as there are tiles, at
// most as many as the card holds at once (read once a device)
template <bool kPiece, bool kVec>
cudaError_t launch_scan_kernel(ScanParams p, cudaStream_t stream) {
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(scan_kernel<kPiece, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel<kPiece, kVec>,
                                                          kScanThreads, kStageBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const int blocks = std::min(p.chunks * p.col_tiles, resident[dev]);
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scan_kernel<kPiece, kVec>),
                                     dim3(blocks), dim3(kScanThreads), args, kStageBytes,
                                     stream);
}

// the tiles of an [s, l] scan, the load width, and the checks the launcher
// made too (a refusal is a fault of the caller); totals must be 16-byte aligned
cudaError_t launch_scan(ScanParams p, bool piece, cudaStream_t stream) {
  if (p.s < 1 || p.l < 1 || p.reps < 1 || !aligned(p.totals, 16)) return cudaErrorInvalidValue;
  p.chunks = (p.s + kScanRows - 1) / kScanRows;
  p.col_tiles = (p.l + kScanCols - 1) / kScanCols;
  if ((int64_t)p.chunks * p.col_tiles >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  const bool vec = p.l % 4 == 0 && aligned(p.tab, 16) && aligned(p.out, 16) &&
                   (!piece || aligned(p.cs, 16));
  if (piece)
    return vec ? launch_scan_kernel<true, true>(p, stream) : launch_scan_kernel<true, false>(p, stream);
  return vec ? launch_scan_kernel<false, true>(p, stream) : launch_scan_kernel<false, false>(p, stream);
}

}  // namespace

extern "C" int taa_rows(const void* idx, int64_t si, int64_t sj, int64_t sk, const void* tab,
                        int tab_bf16, void* out, int s, int l, int steps, int reps, int form,
                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int*>(idx);
  auto o = static_cast<float*>(out);
  return static_cast<int>(
      tab_bf16
          ? launch_rows<__nv_bfloat16>(form, ip, si, sj, sk, tab, o, s, l, steps, reps, st)
          : launch_rows<float>(form, ip, si, sj, sk, tab, o, s, l, steps, reps, st));
}

extern "C" int taa_lanes(const void* idx, int64_t si, int64_t sj, int64_t sk, const void* tab,
                         int tab_bf16, void* out, int s, int l, int steps, int reps, int form,
                         int rows, int tile, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int*>(idx);
  auto o = static_cast<float*>(out);
  if (form == kLanesGroup)
    return static_cast<int>(launch_group(ip, si, sj, sk, tab, tab_bf16, o, s, l, steps, reps,
                                         rows, tile, st));
  if (form != kLanesGeneral) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      tab_bf16 ? launch_lanes<__nv_bfloat16>(ip, si, sj, sk, tab, o, s, l, steps, reps, st)
               : launch_lanes<float>(ip, si, sj, sk, tab, o, s, l, steps, reps, st));
}

extern "C" int cumsum_cols(const void* tab, void* out, void* totals, int s, int l, int reps,
                           void* stream) {
  ScanParams p{};
  p.tab = static_cast<const float*>(tab);
  p.out = static_cast<float*>(out);
  p.totals = static_cast<float*>(totals);
  p.s = s, p.l = l, p.reps = reps;
  return static_cast<int>(launch_scan(p, false, static_cast<cudaStream_t>(stream)));
}

extern "C" int piece(const void* ids, const void* coef, const void* begin, const void* end,
                     const void* tab, void* out, void* cs, void* totals, int s, int l,
                     int reps, void* stream) {
  ScanParams p{};
  p.tab = static_cast<const float*>(tab);
  p.ids = static_cast<const int*>(ids);
  p.coef = static_cast<const float*>(coef);
  p.begin = static_cast<const int*>(begin);
  p.end = static_cast<const int*>(end);
  p.out = static_cast<float*>(out);
  p.cs = static_cast<float*>(cs);
  p.totals = static_cast<float*>(totals);
  p.s = s, p.l = l, p.reps = reps;
  return static_cast<int>(launch_scan(p, true, static_cast<cudaStream_t>(stream)));
}
