// Probe kernels of the two primitives every aggregation kernel here is made
// of: random row gathers, and per-edge accumulation into rows.
//
//   gather_probe:  out[0, f] = sum_{i < m} h[idx[i], f]
//   scatter_probe: out[r, f] = sum_{i < mb, idx[i] == r} coef[i] * h[i mod rows, f]
//                  over sorted idx, out [rows, d] starting at zero
//
// Replace the TPU probes gather_kernel and scatter_kernel
// (scripts/exp_pallas_gather.py:60,85), which measured an in-VMEM jnp.take and
// a per-edge dynamic-index read-modify-write on the TPU. Here h is read from
// device memory and L2.
//
// gather_probe counts, then contracts. The sum regroups exactly as
// out[f] = sum_r count[r] * h[r, f] with count[r] = #{i : idx[i] == r}, so the
// kernel reads the ids once and the table once, which is what its bound
// counts: at the probe's defaults (2^20 ids into [16384, 128] f32) 4.2 MB of
// ids and 8.4 MB of table, 3.8 us at the H100's 3.35 TB/s. Gathering the rows
// instead moves 2^20 * 512 B = 537 MB through L2, which no design can bring
// near that bound (54 us even at 10 TB/s); the card's random row gather is
// measured by kernel 3 and taa_rows (chip_smoke (h), (j)).
// * count: CTAs of 1024 threads take contiguous slices of idx, read with
//   16-byte loads, 4 in flight a thread. On the shared path (a table of at
//   most 58,112 rows: 4 bytes a row within a block's 232,448 bytes) a CTA
//   counts its slice into an int32 histogram in shared memory with shared
//   atomics and writes it whole to its row of counts [blocks, rows]: no
//   global atomic and nothing to clear. The launcher picks the number of
//   count CTAs so that these histograms hold no more ints than idx
//   (kernels.gather_count_blocks); the written histograms, 4 MB at the
//   defaults, are most of the count's time. On
//   the global path (a larger table) every id is a red.global.add into one
//   count array that the caller cleared. Integer counts are exact, so neither
//   the atomics' order nor the merge's matters.
// * contract: at most 128 CTAs of 512 threads take chunks of 128 consecutive
//   table rows in turn. For a chunk, the 16 warps load their 8 rows each
//   (lanes over features) and, while those loads are in flight, 4 threads a
//   row add the row's counts over the count arrays, 16 loads in flight each;
//   then out[f] += count * h[r, f] by FMA (a row that no id names adds
//   nothing). The warps' sums are added pairwise into the CTA's partial row.
// * final: the CTA that finishes last (a ticket in the count scratch, cleared
//   by the count kernel) adds the partial rows per feature, 4 threads a
//   feature taking every fourth row in order (32 loads in flight), then the
//   4 sums pairwise: a fixed order, so the same bits on every run. At the
//   defaults the 16,384 products are summed in chains of 8 rows a lane, then
//   by trees, which keeps the rounding within the probe's 1e-6 of
//   sum_i |h[idx[i]]|.
// A count above 2^24 is rounded to f32 before its product (an error of at
// most 2^-24 of that term). An id outside [0, rows) is not counted: the count
// CTA that meets one sets its flag in the count scratch, and the last CTA of
// the contraction then writes NaN to every element of out (the plain version
// indexes as torch does: it raises for an id >= rows). Nothing is written
// outside the histograms.
//
// scatter_probe: the TPU loop's read-modify-writes become a segmented sum in
// one cooperative launch, each row written once. Its bound is bytes: ids,
// coefficients, the min(mb, rows) rows of h that the terms name and out, once
// (17.3 MB at the defaults, 5.2 us).
// * Split: the ids idx[:mb] are cut into tiles of equal numbers of ids, one a
//   CTA (more, taken in turn, where a tile would pass kScatterMaxIds), and a
//   row is added by the tile that holds its first id, whole: no search, and
//   the 1,021 busy rows of the probe (64 terms each) spread over every SM.
//   probes.gather.scatter_split_plain restates the split.
// * Marks: a tile reads its ids once, coalesced, and marks where neighbouring
//   ids differ: its rows' first terms (compacted by warp ballots, in order).
//   The same read checks that the ids rise and lie in [0, rows).
// * Busy rows: a warp a row, 4 features a lane (one 16-byte load a term where
//   d % 4 == 0 and h and out are 16-byte aligned, else 4 values 32 apart);
//   32 coefficients a load, broadcast by shuffle; 16 terms' rows of h in
//   flight before the first add (8 on the 4-byte path). The warp of a tile's
//   last row first reads on past the tile to that row's end. Terms are added in index order from 0, the
//   product and the sum rounded apart (no FMA), as the TPU loop's
//   out += coef * g rounds them: the same bits as that loop, on every run.
// * Empty rows: one between two busy rows is written 0 by the warp of the one
//   before it; the rows before the first id and after the last go in even
//   shares to the CTAs, stored right after the marks so that they drain
//   while the busy rows are added. No row is written twice, so nothing
//   orders the writes.
// * Faults: a CTA that met an id out of order or out of range sets its flag
//   (a scratch int a CTA, allocated by the wrapper; each CTA writes its own);
//   after the launch's one grid barrier every CTA reads the flags and, if one
//   is set, writes NaN to an even share of out.
// What is left above the bound: a busy row is a chain of in-order adds that
// no design may split (64 terms at the probe's shape, four batches of loads
// from L2 deep), and the terms read every row of h four times (mb = 4 rows:
// 33.5 MB of L2 reads against 8.4 MB of h). Deeper batches (24, 32 terms)
// and rows staged in shared memory measured slower on the H100.
// No atomics and nothing falls back: a launch the card refuses returns its
// error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kSteps = 4;   // 32-wide feature steps per pass: 128 features
constexpr int kWidth = 32 * kSteps;
constexpr int kCountThreads = 1024;
constexpr int kCountIlp = 4;        // 16-byte id loads in flight per counting thread
constexpr int kContractRows = 128;  // table rows a chunk of the contraction
constexpr int kContractCtas = 128;  // most contraction CTAs (kernels.GATHER_CONTRACT_CTAS)
constexpr int kContractWarps = 16;
constexpr int kContractThreads = 32 * kContractWarps;
constexpr int kMergeSlices = kContractThreads / kContractRows;  // threads adding one row's counts
constexpr int kMergeIlp = 16;       // count loads in flight per merging thread
constexpr int kFinalIlp = 32;       // partial-row loads in flight per thread of the last CTA
constexpr int kRowsPerWarp = kContractRows / kContractWarps;
static_assert(kMergeSlices == 4 && kContractThreads / kWidth == 4, "the last CTA's slices");
constexpr int kPathShared = 0, kPathGlobal = 1;  // kernels.GATHER_PATHS

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// one id into hist, if it names a row; else it only marks the thread's flag
__device__ __forceinline__ void count_id(int* hist, int v, int rows, bool& stray) {
  if ((unsigned)v < (unsigned)rows) atomicAdd(hist + v, 1);
  else stray = true;
}

// counts of the ids idx[0, m): shared path, per CTA into counts[blockIdx.x, :];
// global path, all CTAs into counts[:]. The first `head` ids (before the first
// 16-byte boundary) and the last m - head mod 4 are read one by one by CTA 0,
// which also clears the contraction's ticket. Every CTA writes stray[blockIdx.x]:
// 1 if its ids held one outside [0, rows), else 0.
template <bool kShared>
__global__ void __launch_bounds__(kCountThreads)
gather_count_kernel(const int* __restrict__ idx, int* __restrict__ counts, int* __restrict__ ticket,
                    int* __restrict__ stray_flags, int64_t m, int rows, int head) {
  extern __shared__ int bins[];
  int* hist = kShared ? bins : counts;
  bool stray = false;
  if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;
  if (kShared) {
    for (int r = threadIdx.x; r < rows; r += kCountThreads) bins[r] = 0;
    __syncthreads();
  }
  const int4* body = reinterpret_cast<const int4*>(idx + head);
  const int64_t n4 = (m - head) >> 2;
  const int64_t per = (n4 + gridDim.x - 1) / gridDim.x;
  const int64_t q0 = min64(n4, blockIdx.x * per), q1 = min64(n4, q0 + per);
  int64_t q = q0 + threadIdx.x;
  for (; q + (kCountIlp - 1) * kCountThreads < q1; q += kCountIlp * kCountThreads) {
    int4 v[kCountIlp];
#pragma unroll
    for (int u = 0; u < kCountIlp; ++u) v[u] = __ldg(body + q + u * kCountThreads);
#pragma unroll
    for (int u = 0; u < kCountIlp; ++u) {
      count_id(hist, v[u].x, rows, stray);
      count_id(hist, v[u].y, rows, stray);
      count_id(hist, v[u].z, rows, stray);
      count_id(hist, v[u].w, rows, stray);
    }
  }
  for (; q < q1; q += kCountThreads) {
    const int4 v = __ldg(body + q);
    count_id(hist, v.x, rows, stray);
    count_id(hist, v.y, rows, stray);
    count_id(hist, v.z, rows, stray);
    count_id(hist, v.w, rows, stray);
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < head; i += kCountThreads) count_id(hist, idx[i], rows, stray);
    for (int64_t i = head + 4 * n4 + threadIdx.x; i < m; i += kCountThreads)
      count_id(hist, idx[i], rows, stray);
  }
  const int any_stray = __syncthreads_or(stray);  // also the barrier before the copy out
  if (threadIdx.x == 0) stray_flags[blockIdx.x] = any_stray;
  if (kShared) {
    int* row = counts + (int64_t)blockIdx.x * rows;
    for (int r = threadIdx.x; r < rows; r += kCountThreads) row[r] = bins[r];
  }
}

// the pairwise sum of the kContractWarps values part[.][t]
__device__ __forceinline__ float pairwise16(const float (*part)[kWidth], int t) {
  float v[kContractWarps];
#pragma unroll
  for (int w = 0; w < kContractWarps; ++w) v[w] = part[w][t];
#pragma unroll
  for (int n = kContractWarps / 2; n > 0; n /= 2)
#pragma unroll
    for (int w = 0; w < n; ++w) v[w] = v[2 * w] + v[2 * w + 1];
  return v[0];
}

// rows warp, warp + 16, ... of the CTA's slice at features f0 + s * 32 + lane
__device__ __forceinline__ void load_rows(const float* __restrict__ h, int r0, int nr, int d,
                                          int f0, int warp, int lane,
                                          float (&hv)[kRowsPerWarp][kSteps]) {
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int t = warp + u * kContractWarps;
    const float* hrow = h + (int64_t)(r0 + t) * d;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int f = f0 + s * 32 + lane;
      hv[u][s] = t < nr && f < d ? hrow[f] : 0.f;
    }
  }
}

// partial[blockIdx.x, f] = sum over the rows r of the CTA's chunks (128 rows
// each: chunk blockIdx.x, then every gridDim.x-th) of count[r] * h[r, f],
// count[r] = sum_b counts[b, r] over n_counts arrays; the CTA that finishes
// last (by the ticket) adds the partial rows into out, or writes NaN there if
// one of the n_stray count CTAs met an id outside [0, rows)
__global__ void __launch_bounds__(kContractThreads)
gather_contract_kernel(const int* __restrict__ counts, int n_counts,
                       const float* __restrict__ h, float* __restrict__ partial,
                       float* __restrict__ out, int* __restrict__ ticket,
                       const int* __restrict__ stray_flags, int n_stray, int rows, int d) {
  __shared__ int slice_counts[kMergeSlices][kContractRows];
  __shared__ float cnt[kContractRows];
  __shared__ float part[kContractWarps][kWidth];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = (rows + kContractRows - 1) / kContractRows;
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    float acc[kSteps] = {0.f, 0.f, 0.f, 0.f};
    for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
      const int r0 = chunk * kContractRows;
      const int nr = min(kContractRows, rows - r0);
      float hv[kRowsPerWarp][kSteps];
      load_rows(h, r0, nr, d, f0, warp, lane, hv);  // in flight while the counts are added
      {  // thread (slice, t) adds count arrays slice, slice + kMergeSlices, ... of row r0 + t
        const int t = threadIdx.x % kContractRows, slice = threadIdx.x / kContractRows;
        int c = 0;
        if (t < nr) {
          const int* col = counts + r0 + t;
          int b = slice;
          for (; b + (kMergeIlp - 1) * kMergeSlices < n_counts; b += kMergeIlp * kMergeSlices) {
            int v[kMergeIlp];
#pragma unroll
            for (int u = 0; u < kMergeIlp; ++u)
              v[u] = col[(int64_t)(b + u * kMergeSlices) * rows];
#pragma unroll
            for (int u = 0; u < kMergeIlp; ++u) c += v[u];
          }
          for (; b < n_counts; b += kMergeSlices) c += col[(int64_t)b * rows];
        }
        slice_counts[slice][t] = c;
      }
      __syncthreads();
      if (threadIdx.x < nr) {
        int c = 0;
#pragma unroll
        for (int q = 0; q < kMergeSlices; ++q) c += slice_counts[q][threadIdx.x];
        cnt[threadIdx.x] = (float)c;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int t = warp + u * kContractWarps;
        const float c = t < nr ? cnt[t] : 0.f;
        if (c != 0.f)  // a row that no id names adds nothing, whatever it holds
#pragma unroll
          for (int s = 0; s < kSteps; ++s) acc[s] = __fmaf_rn(c, hv[u][s], acc[s]);
      }
      __syncthreads();  // cnt and slice_counts are refilled by the next chunk
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) part[warp][s * 32 + lane] = acc[s];
    __syncthreads();
    if (threadIdx.x < kWidth && f0 + threadIdx.x < d)
      partial[(int64_t)blockIdx.x * d + f0 + threadIdx.x] = pairwise16(part, threadIdx.x);
    __syncthreads();
  }
  // the last CTA: out[f] = the partial rows summed, slice q adding rows q,
  // q + kMergeSlices, ... in order, then the slices pairwise
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int stray = 0;
  for (int b = threadIdx.x; b < n_stray; b += kContractThreads) stray |= stray_flags[b];
  stray = __syncthreads_or(stray);
  const int blocks = gridDim.x;
  const int t = threadIdx.x % kWidth, slice = threadIdx.x / kWidth;
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    const int f = f0 + t;
    float sum = 0.f;
    if (f < d) {
      int b = slice;
      for (; b + (kFinalIlp - 1) * kMergeSlices < blocks; b += kFinalIlp * kMergeSlices) {
        float v[kFinalIlp];
#pragma unroll
        for (int u = 0; u < kFinalIlp; ++u)
          v[u] = __ldcg(partial + (int64_t)(b + u * kMergeSlices) * d + f);
#pragma unroll
        for (int u = 0; u < kFinalIlp; ++u) sum += v[u];
      }
      for (; b < blocks; b += kMergeSlices) sum += __ldcg(partial + (int64_t)b * d + f);
    }
    part[slice][t] = sum;
    __syncthreads();
    if (threadIdx.x < kWidth && f < d)
      out[f] = stray ? __int_as_float(0x7fc00000)  // NaN: an id named no row
                     : (part[0][t] + part[1][t]) + (part[2][t] + part[3][t]);
    __syncthreads();
  }
}

constexpr int kScatterWarps = 8;
constexpr int kScatterThreads = 32 * kScatterWarps;
constexpr int kScatterBatch = 16;      // terms' rows of h in flight a warp
constexpr int kScatterMinCtas = 2;     // CTAs an SM (kernels.SCATTER_CTAS)
constexpr int kScatterMaxIds = 2048;   // ids a tile at most (kernels.SCATTER_TILE_IDS)
constexpr int kMaxDevices = 64;
static_assert(kScatterBatch <= 32, "a coefficient a lane");

struct ScatterParams {
  const int* idx;
  const float* coef;
  const float* h;
  float* out;
  int* flags;  // a fault flag a CTA
  int rows, mb, d, tiles, per;  // per: ids a tile
};

// the 4 features of the lane in the 128 from f0: f0 + 4 lane + s (kVec) or
// f0 + 32 s + lane
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int f0, int lane, int d) {
  if (kVec) {
    const int f = f0 + 4 * lane;
    return f < d ? __ldg(reinterpret_cast<const float4*>(row + f)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float v[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int f = f0 + 32 * s + lane;
    v[s] = f < d ? __ldg(row + f) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int f0, int lane, int d, float4 v) {
  if (kVec) {
    const int f = f0 + 4 * lane;
    if (f < d) *reinterpret_cast<float4*>(row + f) = v;
    return;
  }
  const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int f = f0 + 32 * s + lane;
    if (f < d) row[f] = a[s];
  }
}

template <bool kVec>
__device__ __forceinline__ void fill_row(const ScatterParams& p, int64_t r, float v, int lane) {
  for (int f0 = 0; f0 < p.d; f0 += kWidth)
    store4<kVec>(p.out + r * p.d, f0, lane, p.d, make_float4(v, v, v, v));
}

__device__ __forceinline__ void add_term(float4& acc, float w, float4 v) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
}

// out[r] = the sum over the terms j in [s, e), in order from 0, of
// coef[j] * h[j mod rows]: a warp the row, 4 features a lane; 32
// coefficients a load, broadcast by shuffle, and kScatterBatch rows of h in
// flight before the first add (half as many where a row is 4 loads a lane,
// within the registers of 2 CTAs an SM; a batch of whole terms takes no
// predicates)
template <bool kVec>
__device__ void scatter_row(const ScatterParams& p, int r, int s, int e, int lane) {
  constexpr int kBatch = kVec ? kScatterBatch : kScatterBatch / 2;  // 4 loads a term: half
  const int rows = p.rows, d = p.d;
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = s; j < e; j += 32) {
      const int n = min(32, e - j);
      const float c = lane < n ? __ldg(p.coef + j + lane) : 0.f;
      const int hr = (int)(((unsigned)j + lane) % (unsigned)rows);  // below 2^32
      for (int t0 = 0; t0 < n; t0 += kBatch) {
        float4 v[kBatch];
        if (n - t0 >= kBatch) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            v[u] = load4<kVec>(p.h + (int64_t)__shfl_sync(0xffffffffu, hr, t0 + u) * d, f0, lane, d);
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            add_term(acc, __shfl_sync(0xffffffffu, c, t0 + u), v[u]);
        } else {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int row = __shfl_sync(0xffffffffu, hr, (t0 + u) & 31);
            v[u] = t0 + u < n ? load4<kVec>(p.h + (int64_t)row * d, f0, lane, d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const float w = __shfl_sync(0xffffffffu, c, (t0 + u) & 31);
            if (t0 + u < n) add_term(acc, w, v[u]);
          }
        }
      }
    }
    store4<kVec>(p.out + (int64_t)r * d, f0, lane, d, acc);
  }
}

// Tile t's rows: those whose first term lies in [t per, (t + 1) per), into
// starts / rows_of (the row's first term and its id, in order); starts[n] is
// the tile's end, where the last row may not end. Reads the tile's ids once,
// coalesced; sets fault if one is out of [0, rows) or below the one before
// it. Returns the number of rows.
__device__ int mark_tile(const ScatterParams& p, int t, int* starts, int* rows_of, int* warp_n,
                         bool& fault) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = (int)min64((int64_t)t * p.per, p.mb);
  const int hi = (int)min64((int64_t)lo + p.per, p.mb);
  int n = 0;
  for (int c0 = lo; c0 < hi; c0 += kScatterThreads) {
    const int j = c0 + threadIdx.x;
    const bool in = j < hi;
    const int v = in ? __ldg(p.idx + j) : 0;
    const int prev = in && j > 0 ? __ldg(p.idx + j - 1) : INT_MIN;
    if (in && (v < 0 || v >= p.rows || prev > v)) fault = true;
    const bool start = in && prev != v;
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int at = n;
    for (int w = 0; w < kScatterWarps; ++w) {
      if (w < warp) at += warp_n[w];
      n += warp_n[w];
    }
    if (start) {
      at += __popc(ballot & ((1u << lane) - 1));
      starts[at] = j;
      rows_of[at] = v;
    }
    __syncthreads();  // warp_n is rewritten by the next chunk
  }
  if (threadIdx.x == 0) starts[n] = hi;
  __syncthreads();
  return n;
}

// The end of row r's terms from e on (the first id that is not r, read on by
// the warp until the id changes) and the id there, or last + 1 at the end
__device__ __forceinline__ void row_end(const ScatterParams& p, int r, int e, int last, int lane,
                                        int& end, int& next) {
  for (;; e += 32) {
    const int v = e + lane < p.mb ? __ldg(p.idx + e + lane) : last + 1;
    const unsigned b = __ballot_sync(0xffffffffu, v != r);
    if (b) {
      const int k = __ffs(b) - 1;
      end = e + k;
      next = __shfl_sync(0xffffffffu, v, k);
      return;
    }
  }
}

// Every row is written once before the barrier: a busy row by a warp of the
// CTA whose tile holds its first id; an empty row between two busy ones by
// the warp of the one before it; and the rows before the first id and after
// the last, in an even share a CTA. After the barrier, if a CTA met a fault,
// each CTA writes NaN to its even share of all rows.
template <bool kVec>
__global__ void __launch_bounds__(kScatterThreads, kScatterMinCtas)
scatter_kernel(const ScatterParams p) {
  __shared__ int starts[kScatterMaxIds + 1];
  __shared__ int rows_of[kScatterMaxIds];
  __shared__ int warp_n[kScatterWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = p.mb ? __ldg(p.idx) : p.rows, last = p.mb ? __ldg(p.idx + p.mb - 1) : p.rows - 1;
  bool fault = false;
  int t = blockIdx.x;
  int n = t < p.tiles ? mark_tile(p, t, starts, rows_of, warp_n, fault) : 0;
  {  // the rows outside [first, last]: k < first is row k, else row k + last - first + 1
    const int64_t outer = (int64_t)first + (p.rows - 1 - (int64_t)last);
    const int64_t k1 = (int64_t)(blockIdx.x + 1) * outer / gridDim.x;
    for (int64_t k = (int64_t)blockIdx.x * outer / gridDim.x + warp; k < k1; k += kScatterWarps) {
      const int64_t r = k < first ? k : k + last - first + 1;
      if (r >= 0 && r < p.rows) fill_row<kVec>(p, r, 0.f, lane);
    }
  }
  while (t < p.tiles) {
    for (int q = warp; q < n; q += kScatterWarps) {
      const int r = rows_of[q];
      int end = starts[q + 1], next = q + 1 < n ? rows_of[q + 1] : 0;
      if (q + 1 == n) row_end(p, r, end, last, lane, end, next);  // may run past the tile
      if (r < 0 || r >= p.rows) continue;  // a fault: out is made NaN below
      scatter_row<kVec>(p, r, starts[q], end, lane);
      for (int z = r + 1; z < next && z < p.rows; ++z) fill_row<kVec>(p, z, 0.f, lane);
    }
    __syncthreads();  // starts and rows_of are refilled by the next tile
    t += gridDim.x;
    if (t < p.tiles) n = mark_tile(p, t, starts, rows_of, warp_n, fault);
  }
  const int any = __syncthreads_or(fault);
  if (threadIdx.x == 0) p.flags[blockIdx.x] = any;
  cooperative_groups::this_grid().sync();
  int bad = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += kScatterThreads) bad |= p.flags[b];
  if (!__syncthreads_or(bad)) return;
  const int64_t r0 = (int64_t)blockIdx.x * p.rows / gridDim.x;
  const int64_t r1 = (int64_t)(blockIdx.x + 1) * p.rows / gridDim.x;
  for (int64_t r = r0 + warp; r < r1; r += kScatterWarps)
    fill_row<kVec>(p, r, __int_as_float(0x7fc00000), lane);  // NaN: ids out of order or range
}

bool aligned(const void* q, int bytes) { return reinterpret_cast<uintptr_t>(q) % bytes == 0; }

// one cooperative launch of `ctas` CTAs, at most as many as the card keeps
// resident (read once a device)
template <bool kVec>
cudaError_t launch_scatter(ScatterParams p, int ctas, cudaStream_t stream) {
  static int resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_kernel<kVec>,
                                                        kScatterThreads, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm * sms == 0) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scatter_kernel<kVec>),
                                     dim3(ctas < resident[dev] ? ctas : resident[dev]),
                                     dim3(kScatterThreads), args, 0, stream);
}

}  // namespace

// counts: int32 scratch, the count arrays ([count_blocks * rows] on the shared
// path, [rows] zeros on the global path), then the contraction's ticket, then
// a stray-id flag a count CTA ([count_blocks]; none needs clearing);
// partial: [min(ceil(rows / 128), 128), d] f32 scratch
extern "C" int gather_probe(const void* idx, const void* h, void* counts, void* partial,
                            void* out, int64_t m, int rows, int d, int count_blocks,
                            int path, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const size_t bins = (size_t)rows * sizeof(int);
  if (m < 0 || m >= (int64_t(1) << 31) || rows < 1 || count_blocks < 1 ||
      (path == kPathShared && bins > 232448u) || (path != kPathShared && path != kPathGlobal))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ip = static_cast<const int*>(idx);
  auto cp = static_cast<int*>(counts);
  int* ticket = cp + (path == kPathShared ? (int64_t)count_blocks * rows : rows);
  int* stray = ticket + 1;
  const int64_t lead = ((16 - reinterpret_cast<uintptr_t>(ip) % 16) % 16) / 4;
  const int head = (int)(lead < m ? lead : m);  // ids before the first 16-byte boundary
  cudaError_t err;
  if (path == kPathShared) {
    if (bins > (48u << 10)) {
      err = cudaFuncSetAttribute(gather_count_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bins);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    gather_count_kernel<true><<<count_blocks, kCountThreads, bins, s>>>(ip, cp, ticket, stray,
                                                                         m, rows, head);
  } else {
    gather_count_kernel<false><<<count_blocks, kCountThreads, 0, s>>>(ip, cp, ticket, stray, m,
                                                                       rows, head);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (rows + kContractRows - 1) / kContractRows;
  const int blocks = chunks < kContractCtas ? chunks : kContractCtas;
  gather_contract_kernel<<<blocks, kContractThreads, 0, s>>>(
      cp, path == kPathShared ? count_blocks : 1, static_cast<const float*>(h),
      static_cast<float*>(partial), static_cast<float*>(out), ticket, stray, count_blocks, rows,
      d);
  return static_cast<int>(cudaGetLastError());
}

// flags: int32 scratch of `ctas` values (none needs clearing); the ids are
// cut into max(ctas, ceil(mb / 2048)) tiles
extern "C" int scatter_probe(const void* idx, const void* coef, const void* h, void* out,
                             void* flags, int rows, int mb, int d, int ctas, void* stream) {
  if (rows < 1 || mb < 0 || d < 1 || ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  ScatterParams p;
  p.idx = static_cast<const int*>(idx);
  p.coef = static_cast<const float*>(coef);
  p.h = static_cast<const float*>(h);
  p.out = static_cast<float*>(out);
  p.flags = static_cast<int*>(flags);
  p.rows = rows;
  p.mb = mb;
  p.d = d;
  p.tiles = (int)std::max<int64_t>(ctas, ((int64_t)mb + kScatterMaxIds - 1) / kScatterMaxIds);
  p.per = (int)std::max<int64_t>(1, ((int64_t)mb + p.tiles - 1) / p.tiles);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned(h, 16) && aligned(out, 16);
  return static_cast<int>(vec ? launch_scatter<true>(p, ctas, s) : launch_scatter<false>(p, ctas, s));
}
