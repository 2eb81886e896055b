// GCNII's convolution epilogue (models/gcnii.py, ops/epilogue.py), forward and
// backward, over rows of H = 64 features.
//
// Forward, convolution l of the fused epoch's pair, once its blended pass
// (ell_blend: s = (1 - alpha) * A h + alpha * h0) has written st and se:
//
//   z    = theta * (s W) + (1 - theta) * s     each half, f32 FMAs (no TF32)
//   h    = ReLU(z)
//   keep = the next layer's dropout mask, drawn here (Philox, below)
//   out  = keep ? h * (1/q) : 0  (training half),  h  (evaluation half)
//
// written straight into the [N, 2H] input of the next blended pass (the
// training half in columns 0..H-1, the evaluation half in H..2H-1: no
// concatenation), or into two [N, H] tensors for the output layer, which
// takes the halves apart; beside them keep (bool [N, H], saved for the
// backward: the layer's mask) and ReLU's sign as bits (int32 [N, H/32]: bit
// c % 32 of word c / 32 is column c).
//
// Backward, the training half, from g, the gradient of its out:
//
//   gz = [z > 0] * (keep ? g * (1/q) : 0)
//   gs = theta * (gz W^T) + (1 - theta) * gz
//
// both written (dW = theta * st^T gz is a cuBLAS product of the saved st).
//
// Replaces no TPU kernel: the JAX package has no GCNII. On the card ATen ran
// the chain as separate passes over [N, H] f32 tensors (59.6 MB each at
// synth-reddit's 232,965 rows): dropout's rand, compare, scale and where, the
// pair's concatenation, two addmm that each copy s into their output first, two
// ReLUs; in the backward ReLU's, the identity map's product, scale and add, and
// dropout's where: about 2.8 GB a layer. This pair of kernels moves 0.45 GB.
//
// Bound on the H100 (synth-reddit): forward 255 MB (st and se read, both halves,
// keep and the bits written; 0.076 ms at 3.35 TB/s) beside 3.8 GFLOP of f32
// FMAs (0.057 ms at 67 TFLOP/s); backward 195 MB (g, keep and the bits read, gz
// and gs written; 0.058 ms) beside 1.9 GFLOP (0.029 ms). Both stream their rows
// once, so the FMAs have to run under the copies:
//
// * A persistent CTA a quarter SM (4 warps) holds the 64 x 64 product's right
//   operand whole in shared memory (W^T forward, W backward, as rows of k) and
//   streams tiles of 64 rows through two stages by 16-byte cp.async, the next
//   tile's copy in flight while it works on the current one. Forward, a tile is
//   one half of 64 rows (the training halves first, then the evaluation ones).
// * The product: a thread owns 4 rows (rg + 16 i) and 8 columns (cg + 8 t) of
//   the tile's output, 32 sums in registers; per 4 k it reads its rows' 4 and
//   its columns' 8 float4 from shared memory (rows padded to 68 floats: each
//   warp's loads hit 32 distinct banks) for 128 FMAs. Each output is one FMA
//   chain over k in order.
// * The epilogue goes through shared memory: each thread writes its outputs'
//   theta * sum + (1 - theta) * s over s, then the tile leaves by rows, 4
//   columns a thread, in float4 stores, which is also the unit of a Philox
//   call: ReLU, the mask, the scale, keep as 4 bytes and the sign bits, OR-ed
//   across the 8 threads of a 32-column word by shuffles.
// * Every output has one writer and a fixed order of additions: no atomics,
//   the same bits on every run.
//
// Measured at synth-reddit on an H100 80GB HBM3 (700 W): forward 0.164 ms,
// backward 0.126 ms a launch, 47% of their bytes bound; the tiles' FMAs and
// Philox calls run beside the copies less than this design allows for.
//
// The arithmetic is ATen's, which ran it before: theta * sum and (1 - theta) *
// s rounded apart and then added (the reference's order); ReLU as threshold (NaN
// kept) and its gradient where z <= 0 fails; the dropout's scale is the f32
// product by `scale`, the kernels.gcnii_dropout constant, which is the
// operation ATen performs for x / (1 - p) with a host scalar on the card.
//
// The mask is drawn as the dense layer-0 kernel draws its own (layer0_pair.cu):
// Philox4x32-10 keyed by a seed and a counter offset that the caller draws on
// the device from the job's generator for each launch (two int64 read here:
// a replayed CUDA graph draws fresh masks, and every launch, so every layer and
// every step, has a key and a counter range of its own). Call c = row * H/4 +
// column / 4 covers 4 columns of a row, a 32-bit word each, kept where the
// word is below thresh = q * 2^32 (ops/epilogue.gcnii_keep restates it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;                      // features a row
constexpr int kThreads = 128;               // a CTA: 16 row groups of 8 threads
constexpr int kRows = 64;                   // rows of a tile
constexpr int kGroup = 8;                   // threads of a row group
constexpr int kRowStep = kThreads / kGroup; // 16: a thread's rows are rg + 16 i
constexpr int kRowsPer = kRows / kRowStep;  // 4
constexpr int kCols = kH / kGroup;          // 8: a thread's columns are cg + 8 t
constexpr int kLd = kH + 4;                 // floats a row of shared memory
constexpr int kTile = kRows * kLd;          // floats of a tile
constexpr int kChunks = kRows * kH / 4;     // float4 of a tile
constexpr int kSmemBytes = 3 * kTile * 4;   // the right operand and two stages
constexpr int kMinCtas = 4;                 // CTAs an SM (__launch_bounds__)
static_assert(kChunks % kThreads == 0 && kH % 32 == 0, "tile shapes");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

// Philox4x32-10 (Salmon et al., SC'11): four 32-bit uniforms of `c` under `key`.
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

// Rows [row0, row0 + kRows) of the [n, kH] tensor `src` into `tile`, the rows
// past n zero-filled.
__device__ __forceinline__ void load_tile(float* tile, const float* src, long long row0,
                                          long long n, int tid) {
#pragma unroll
  for (int i = tid; i < kChunks; i += kThreads) {
    const int r = i / (kH / 4), c4 = i % (kH / 4);
    const bool in = row0 + r < n;
    cp_async16(smem_addr(tile + r * kLd + 4 * c4), in ? src + (row0 + r) * kH + 4 * c4 : src,
               in ? 16 : 0);
  }
}

// acc[i][t] = sum_k a[rg + 16 i][k] * b[cg + 8 t][k], k in order.
__device__ __forceinline__ void product(const float* a, const float* b, int rg, int cg,
                                        float (&acc)[kRowsPer][kCols]) {
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) acc[i][t] = 0.0f;
  }
#pragma unroll 2
  for (int k = 0; k < kH; k += 4) {
    float4 x[kRowsPer], y[kCols];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      x[i] = *reinterpret_cast<const float4*>(a + (rg + kRowStep * i) * kLd + k);
    }
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      y[t] = *reinterpret_cast<const float4*>(b + (cg + kGroup * t) * kLd + k);
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
      for (int t = 0; t < kCols; ++t) {
        float s = acc[i][t];
        s = fmaf(x[i].x, y[t].x, s);
        s = fmaf(x[i].y, y[t].y, s);
        s = fmaf(x[i].z, y[t].z, s);
        s = fmaf(x[i].w, y[t].w, s);
        acc[i][t] = s;
      }
    }
  }
}

// tile[r][j] = theta * acc + (1 - theta) * tile[r][j] over the thread's
// outputs: each product rounded, then their sum.
__device__ __forceinline__ void blend_in_place(float* tile, const float (&acc)[kRowsPer][kCols],
                                               int rg, int cg, float theta, float omt) {
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      float& v = tile[(rg + kRowStep * i) * kLd + cg + kGroup * t];
      v = __fadd_rn(__fmul_rn(theta, acc[i][t]), __fmul_rn(omt, v));
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

struct Fwd {
  const float* st;           // [n, kH]: the training half's blended pass
  const float* se;           // [n, kH]: the evaluation half's
  const float* w;            // [kH, kH]
  const long long* seeds;    // Philox key and counter offset, drawn on the device
  float* out_t;              // row r at out_t + r * ld
  float* out_e;              // row r at out_e + r * ld
  long long ld;
  uint32_t* keep;            // [n, kH] bool, 4 a word
  uint32_t* relu;            // [n, kH / 32]
  long long n;
  float theta, omt, scale;   // theta, 1 - theta, 1 / (1 - p) as ATen rounds it
  unsigned long long thresh; // keep below it (q * 2^32)
};

__global__ void __launch_bounds__(kThreads, kMinCtas) gcnii_epilogue_kernel(const Fwd a) {
  extern __shared__ __align__(16) float smem[];
  float* const wt = smem;  // W^T: wt[j][k] = W[k][j]
  float* const stages = smem + kTile;
  const int tid = threadIdx.x, rg = tid / kGroup, cg = tid % kGroup;
  const long long tiles = (a.n + kRows - 1) / kRows, items = 2 * tiles;
  const auto src = [&](long long it) { return it < tiles ? a.st : a.se; };
  const auto row0 = [&](long long it) { return (it < tiles ? it : it - tiles) * kRows; };

  long long item = blockIdx.x;
  if (item < items) load_tile(stages, src(item), row0(item), a.n, tid);
  cp_async_commit();
  for (int i = tid; i < kH * kH; i += kThreads) wt[(i % kH) * kLd + i / kH] = __ldg(a.w + i);
  const unsigned long long seed = static_cast<unsigned long long>(__ldg(a.seeds));
  const unsigned long long offset = static_cast<unsigned long long>(__ldg(a.seeds + 1));
  const uint2 key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));

  float acc[kRowsPer][kCols];
  int s = 0;
  while (item < items) {
    const long long next = item + gridDim.x;
    if (next < items) load_tile(stages + (1 - s) * kTile, src(next), row0(next), a.n, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the tile (and, the first time, W^T) is in
    float* const tile = stages + s * kTile;
    product(tile, wt, rg, cg, acc);
    __syncthreads();  // every row of s is read: z goes over it
    blend_in_place(tile, acc, rg, cg, a.theta, a.omt);
    __syncthreads();
    const bool train = item < tiles;
    const long long r0 = row0(item);
    float* const out = train ? a.out_t : a.out_e;
#pragma unroll 2
    for (int i = tid; i < kChunks; i += kThreads) {
      const int lr = i / (kH / 4), c4 = i % (kH / 4);
      const long long r = r0 + lr;
      const float4 z = ld4(tile + lr * kLd + 4 * c4);
      float v[4] = {z.x, z.y, z.z, z.w};
      uint32_t sign = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool pos = !(v[j] <= 0.0f);  // ReLU as threshold: NaN passes
        sign |= static_cast<uint32_t>(pos) << j;
        v[j] = pos ? v[j] : 0.0f;
      }
      if (train) {
        uint32_t word = sign << (4 * (c4 % 8));
        word |= __shfl_xor_sync(0xffffffffu, word, 1);
        word |= __shfl_xor_sync(0xffffffffu, word, 2);
        word |= __shfl_xor_sync(0xffffffffu, word, 4);
        const unsigned long long call = static_cast<unsigned long long>(r) * (kH / 4) + c4;
        const uint4 u = philox(key, make_uint4(static_cast<uint32_t>(call),
                                               static_cast<uint32_t>(call >> 32),
                                               static_cast<uint32_t>(offset),
                                               static_cast<uint32_t>(offset >> 32)));
        const uint32_t bits[4] = {u.x, u.y, u.z, u.w};
        uint32_t kept = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool k = bits[j] < a.thresh;
          kept |= static_cast<uint32_t>(k) << (8 * j);
          v[j] = k ? __fmul_rn(v[j], a.scale) : 0.0f;
        }
        if (r < a.n) {
          a.keep[r * (kH / 4) + c4] = kept;
          if (c4 % 8 == 0) a.relu[r * (kH / 32) + c4 / 8] = word;
        }
      }
      if (r < a.n) st4(out + r * a.ld + 4 * c4, v);
    }
    __syncthreads();  // the tile is read out: the next copy may land in it
    item = next;
    s ^= 1;
  }
  cp_async_wait<0>();
}

struct Bwd {
  const float* g;          // [n, kH]: the gradient of the training half's out
  const uint32_t* keep;    // [n, kH] bool, 4 a word
  const uint32_t* relu;    // [n, kH / 32]
  const float* w;          // [kH, kH]
  float* gz;               // [n, kH]
  float* gs;               // [n, kH]
  long long n;
  float theta, omt, scale;
};

__global__ void __launch_bounds__(kThreads, kMinCtas) gcnii_epilogue_bwd_kernel(const Bwd a) {
  extern __shared__ __align__(16) float smem[];
  float* const wn = smem;  // W as it is: wn[j][k] = W[j][k]
  float* const stages = smem + kTile;
  const int tid = threadIdx.x, rg = tid / kGroup, cg = tid % kGroup;
  const long long items = (a.n + kRows - 1) / kRows;

  for (int i = tid; i < kH * kH / 4; i += kThreads) {
    cp_async16(smem_addr(wn + (i / (kH / 4)) * kLd + 4 * (i % (kH / 4))), a.w + 4 * i, 16);
  }
  long long item = blockIdx.x;
  if (item < items) load_tile(stages, a.g, item * kRows, a.n, tid);
  cp_async_commit();

  float acc[kRowsPer][kCols];
  int s = 0;
  while (item < items) {
    const long long next = item + gridDim.x;
    if (next < items) load_tile(stages + (1 - s) * kTile, a.g, next * kRows, a.n, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* const tile = stages + s * kTile;
    const long long r0 = item * kRows;
    // gz over g, by rows, and written out
#pragma unroll 2
    for (int i = tid; i < kChunks; i += kThreads) {
      const int lr = i / (kH / 4), c4 = i % (kH / 4);
      const long long r = r0 + lr;
      const bool in = r < a.n;
      const uint32_t kept = in ? __ldg(a.keep + r * (kH / 4) + c4) : 0u;
      const uint32_t sign = in ? __ldg(a.relu + r * (kH / 32) + c4 / 8) >> (4 * (c4 % 8)) : 0u;
      const float4 gv = ld4(tile + lr * kLd + 4 * c4);
      const float g[4] = {gv.x, gv.y, gv.z, gv.w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool pass = ((sign >> j) & 1u) && ((kept >> (8 * j)) & 1u);
        v[j] = pass ? __fmul_rn(g[j], a.scale) : 0.0f;
      }
      st4(tile + lr * kLd + 4 * c4, v);
      if (in) st4(a.gz + r * kH + 4 * c4, v);
    }
    __syncthreads();
    product(tile, wn, rg, cg, acc);
    __syncthreads();
    blend_in_place(tile, acc, rg, cg, a.theta, a.omt);
    __syncthreads();
#pragma unroll 2
    for (int i = tid; i < kChunks; i += kThreads) {
      const int lr = i / (kH / 4), c4 = i % (kH / 4);
      const long long r = r0 + lr;
      if (r < a.n) {
        const float4 v = ld4(tile + lr * kLd + 4 * c4);
        *reinterpret_cast<float4*>(a.gs + r * kH + 4 * c4) = v;
      }
    }
    __syncthreads();
    item = next;
    s ^= 1;
  }
  cp_async_wait<0>();
}

// A persistent grid: as many CTAs as the SMs hold of `kernel`, at most one an
// item. Read from the device once a kernel (not while a graph is captured:
// the eager first epoch comes first).
template <class K>
cudaError_t grid_of(K kernel, int* ctas) {
  static int cached = 0;
  if (cached == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached = sms * per_sm;
  }
  *ctas = cached;
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The forward over n rows of st and se (f32 [n, h], h = 64), W f32 [h, h]:
// out_t / out_e rows `ld` floats apart (2h: the two halves of one [n, 2h]
// buffer; h: tensors of their own), keep [n, h] bool, relu [n, h / 32] int32.
// An element is kept where its 32 bits of Philox (under seeds) lie below
// `thresh`; theta and omt = 1 - theta as f32; `scale` the kept values' factor.
extern "C" int gcnii_epilogue(const void* st, const void* se, const void* w, const void* seeds,
                              void* out_t, void* out_e, long long ld, void* keep, void* relu,
                              long long n, int h, float theta, float omt, float scale,
                              long long thresh, void* stream) {
  if (n <= 0 || h != kH || ld % 4 || ld < h || thresh < 0 || !aligned16(st) || !aligned16(se) ||
      !aligned16(out_t) || !aligned16(out_e) || reinterpret_cast<uintptr_t>(keep) % 4 ||
      reinterpret_cast<uintptr_t>(relu) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ctas = 0;
  cudaError_t err = grid_of(gcnii_epilogue_kernel, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  Fwd a;
  a.st = static_cast<const float*>(st);
  a.se = static_cast<const float*>(se);
  a.w = static_cast<const float*>(w);
  a.seeds = static_cast<const long long*>(seeds);
  a.out_t = static_cast<float*>(out_t);
  a.out_e = static_cast<float*>(out_e);
  a.ld = ld;
  a.keep = static_cast<uint32_t*>(keep);
  a.relu = static_cast<uint32_t*>(relu);
  a.n = n;
  a.theta = theta;
  a.omt = omt;
  a.scale = scale;
  a.thresh = static_cast<unsigned long long>(thresh);
  const long long items = 2 * ((n + kRows - 1) / kRows);
  gcnii_epilogue_kernel<<<static_cast<unsigned>(items < ctas ? items : ctas), kThreads,
                          kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The backward over n rows: g f32 [n, h] (h = 64), keep and relu as the
// forward wrote them, W f32 [h, h]; writes gz and gs, f32 [n, h].
extern "C" int gcnii_epilogue_bwd(const void* g, const void* keep, const void* relu,
                                  const void* w, void* gz, void* gs, long long n, int h,
                                  float theta, float omt, float scale, void* stream) {
  if (n <= 0 || h != kH || !aligned16(g) || !aligned16(w) || !aligned16(gz) || !aligned16(gs) ||
      reinterpret_cast<uintptr_t>(keep) % 4 || reinterpret_cast<uintptr_t>(relu) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ctas = 0;
  cudaError_t err = grid_of(gcnii_epilogue_bwd_kernel, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  Bwd a;
  a.g = static_cast<const float*>(g);
  a.keep = static_cast<const uint32_t*>(keep);
  a.relu = static_cast<const uint32_t*>(relu);
  a.w = static_cast<const float*>(w);
  a.gz = static_cast<float*>(gz);
  a.gs = static_cast<float*>(gs);
  a.n = n;
  a.theta = theta;
  a.omt = omt;
  a.scale = scale;
  const long long items = (n + kRows - 1) / kRows;
  gcnii_epilogue_bwd_kernel<<<static_cast<unsigned>(items < ctas ? items : ctas), kThreads,
                              kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
