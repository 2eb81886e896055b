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
// cumsum_cols and piece share one three-pass scan: per (chunk of 64 rows,
// column) a thread adds its chunk's values; one thread per column turns the
// chunk totals into exclusive offsets, in chunk order; then each thread scans
// its chunk from its offset and writes. One writer per element and a fixed
// order of additions: no atomics, the same bits on every run. The scan is
// taken once per launch and the last addition repeated `reps` times in order,
// which for finite inputs is what the TPU loops compute (cumsum_kernel's
// `tab + acc * 0` only differs when acc holds an infinity or a NaN, and that
// is not reproduced). piece scans the gathered, scaled values (product and
// sums rounded apart) into a scratch scan with a leading zero row, and a last
// kernel reads the two boundary rows.
//
// Bound on the H100: bytes for all four (each input read once, out written
// once); the gathers are served mostly from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kLaneTile = 1024;           // columns per CTA of taa_lanes
constexpr int kMaxStageBytes = 200 << 10; // largest table row staged in shared memory
constexpr int kScanRows = 64;             // rows per scan chunk
constexpr int kScanThreads = 128;         // columns per scan CTA

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

// the scanned values: a table, or gathered rows of it scaled per row
struct TableSource {
  const float* tab;
  int l;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return tab[(int64_t)i * l + j];
  }
};

struct PieceSource {
  const float* tab;
  const int* ids;
  const float* coef;
  int l;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return __fmul_rn(tab[(int64_t)ids[i] * l + j], coef[i]);
  }
};

// totals[c, j] = sum of the values of chunk c in column j, in row order
template <class Src>
__global__ void __launch_bounds__(kScanThreads)
scan_totals_kernel(Src src, float* __restrict__ totals, int s, int l) {
  const int j = blockIdx.x * kScanThreads + threadIdx.x;
  if (j >= l) return;
  const int r0 = blockIdx.y * kScanRows, r1 = min(s, r0 + kScanRows);
  float sum = 0.f;
#pragma unroll 8
  for (int i = r0; i < r1; ++i) sum += src(i, j);
  totals[(int64_t)blockIdx.y * l + j] = sum;
}

// in place: totals[c, j] -> sum of totals[c' < c, j], in chunk order
__global__ void __launch_bounds__(kScanThreads)
scan_offsets_kernel(float* totals, int chunks, int l) {
  const int j = blockIdx.x * kScanThreads + threadIdx.x;
  if (j >= l) return;
  float run = 0.f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) {
    float* p = totals + (int64_t)c * l + j;
    const float t = *p;
    *p = run;
    run += t;
  }
}

// out[lead + i, j] = reps additions of (offset of i's chunk + the chunk's
// values up to and including row i); with lead = 1, row 0 is written 0
template <class Src>
__global__ void __launch_bounds__(kScanThreads)
scan_write_kernel(Src src, const float* __restrict__ offsets, float* __restrict__ out, int s,
                  int l, int reps, int lead) {
  const int j = blockIdx.x * kScanThreads + threadIdx.x;
  if (j >= l) return;
  const int r0 = blockIdx.y * kScanRows, r1 = min(s, r0 + kScanRows);
  if (lead && blockIdx.y == 0) out[j] = 0.f;
  float run = offsets[(int64_t)blockIdx.y * l + j];
#pragma unroll 8
  for (int i = r0; i < r1; ++i) {
    run += src(i, j);
    float acc = 0.f;
    for (int r = 0; r < reps; ++r) acc += run;
    out[(int64_t)(i + lead) * l + j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
piece_diff_kernel(const float* __restrict__ cs, const int* __restrict__ begin,
                  const int* __restrict__ end, float* __restrict__ out, int l, int reps,
                  int64_t total) {
  const int64_t t = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t i = t / l;
  const int j = (int)(t - i * l);
  const float diff = cs[(int64_t)end[i] * l + j] - cs[(int64_t)begin[i] * l + j];
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) acc += diff;
  out[t] = acc;
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

// the three scan passes over `src`; totals is [chunks, l] scratch
template <class Src>
cudaError_t launch_scan(Src src, float* totals, float* out, int s, int l, int reps, int lead,
                        cudaStream_t stream) {
  const int chunks = (s + kScanRows - 1) / kScanRows;
  const int col_blocks = (l + kScanThreads - 1) / kScanThreads;
  const dim3 grid(col_blocks, chunks);
  scan_totals_kernel<Src><<<grid, kScanThreads, 0, stream>>>(src, totals, s, l);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_offsets_kernel<<<col_blocks, kScanThreads, 0, stream>>>(totals, chunks, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_write_kernel<Src><<<grid, kScanThreads, 0, stream>>>(src, totals, out, s, l, reps, lead);
  return cudaGetLastError();
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
  const TableSource src{static_cast<const float*>(tab), l};
  return static_cast<int>(launch_scan(src, static_cast<float*>(totals),
                                      static_cast<float*>(out), s, l, reps, 0,
                                      static_cast<cudaStream_t>(stream)));
}

extern "C" int piece(const void* ids, const void* coef, const void* begin, const void* end,
                     const void* tab, void* out, void* cs, void* totals, int s, int l,
                     int reps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const PieceSource src{static_cast<const float*>(tab), static_cast<const int*>(ids),
                        static_cast<const float*>(coef), l};
  const cudaError_t err = launch_scan(src, static_cast<float*>(totals),
                                      static_cast<float*>(cs), s, l, 1, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)s * l;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  piece_diff_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(cs), static_cast<const int*>(begin),
      static_cast<const int*>(end), static_cast<float*>(out), l, reps, total);
  return static_cast<int>(cudaGetLastError());
}
