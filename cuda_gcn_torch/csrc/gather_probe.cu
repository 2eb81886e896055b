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
// scatter_probe: the TPU loop's read-modify-writes become a segmented sum:
// one warp per output row finds its segment of the sorted idx by binary
// search and adds the segment's terms in index order, lanes over features.
// Every output row has one writer (rows with no term are written 0): no
// atomics, deterministic. Products and sums are rounded separately (no FMA),
// as the TPU loop's out += coef * g rounds them. Bound: bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per CTA of scatter
constexpr int kSteps = 4;   // 32-wide feature steps per pass: 128 features
constexpr int kWidth = 32 * kSteps;
constexpr int kIlp = 4;     // terms in flight per warp of scatter
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

// first i in [0, n) with idx[i] >= key
__device__ __forceinline__ int first_at_least(const int* __restrict__ idx, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (idx[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kWarps * 32)
scatter_kernel(const int* __restrict__ idx, const float* __restrict__ coef,
               const float* __restrict__ h, float* __restrict__ out, int rows, int mb,
               int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lo = first_at_least(idx, mb, r), hi = first_at_least(idx, mb, r + 1);
  float* orow = out + (int64_t)r * d;
  for (int f0 = 0; f0 < d; f0 += kWidth) {
    float acc[kSteps] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = lo; i0 < hi; i0 += kIlp) {
      float wk[kIlp];
      float hv[kIlp][kSteps];
#pragma unroll
      for (int u = 0; u < kIlp; ++u) {
        const int i = i0 + u;
        wk[u] = i < hi ? coef[i] : 0.f;
        const float* hrow = h + (int64_t)(i % rows) * d;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int f = f0 + s * 32 + lane;
          hv[u][s] = (i < hi && f < d) ? hrow[f] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kIlp; ++u)
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
          if (i0 + u < hi) acc[s] = __fadd_rn(acc[s], __fmul_rn(wk[u], hv[u][s]));
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int f = f0 + s * 32 + lane;
      if (f < d) orow[f] = acc[s];
    }
  }
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

extern "C" int scatter_probe(const void* idx, const void* coef, const void* h, void* out,
                             int rows, int mb, int d, void* stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  scatter_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(coef),
      static_cast<const float*>(h), static_cast<float*>(out), rows, mb, d);
  return static_cast<int>(cudaGetLastError());
}
