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
// taa_lanes: a CTA stages its table row in shared memory (above 48 KB by
// opt-in; a row that does not fit is read from global memory) and walks a tile
// of the columns. In all of them, the sum starts at 0 and adds step after step, rep
// after rep, in f32, and every rep reads the table again (a compiler barrier
// keeps the loads inside the loop): the probes time gathers, not additions.
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
                         int tab_bf16, void* out, int s, int l, int steps, int reps,
                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto ip = static_cast<const int*>(idx);
  auto o = static_cast<float*>(out);
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
