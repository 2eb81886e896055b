// Thin wrappers over the Hopper (sm_90a) PTX that kernel 1 is built from:
// mbarriers, TMA tensor loads, and the warpgroup matrix multiply wgmma with
// both operands read from shared memory through matrix descriptors; and the
// bulk copies that the dense layer-0 kernel (layer0_pair.cu) streams with.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to the
// other threads once they pass the following __syncthreads().
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival, and `bytes` of TMA traffic to wait for in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// Box at coordinates (c0 innermost, ...) of the tensor map -> shared memory;
// the bytes are counted on the barrier as they land.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- bulk copies (the TMA without a tensor map) ------------------------------

// `bytes` (a multiple of 16, both addresses on 16 bytes) global -> shared;
// they are counted on the barrier as they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` (as above) shared -> global, in this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's writes to shared memory before the bulk copies (the
// async proxy) that later read it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Matrix descriptor of an operand in shared memory in the 128-byte-swizzle
// layout that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128
// bytes, 8 of them (1024 bytes) one swizzle atom, atoms 1024 bytes apart (the
// stride byte offset). The leading byte offset is not read for a K-major
// operand, nor for an MN-major one that is one atom (64 elements) wide.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  uint64_t desc = (addr & 0x3FFFF) >> 4;  // start address, 16-byte units
  desc |= uint64_t(1) << 16;              // leading byte offset (unused)
  desc |= uint64_t(1024 >> 4) << 32;      // stride byte offset
  desc |= uint64_t(1) << 62;              // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(i) ACC4(i), ACC4(i + 4)
#define ACC16(i) ACC8(i), ACC8(i + 8)

// d[64 x N] += A[64 x 16] * B[16 x N]: bf16 operands from shared memory, f32
// accumulators in the warpgroup's registers (N / 2 per thread). B is K-major
// (N rows of 16 contiguous k). TA = 0: A is K-major (64 rows of contiguous k);
// TA = 1: A is MN-major (16 rows of k, 64 contiguous m), so the product takes
// the stored tile transposed.
template <int N, int TA>
struct Wgmma;

template <int TA>
struct Wgmma<16, TA> {
  static __device__ __forceinline__ void run(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %10, 0;\n}\n"
        : ACC8(0)
        : "l"(a), "l"(b), "n"(TA));
  }
};

template <int TA>
struct Wgmma<32, TA> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %18, 0;\n}\n"
        : ACC16(0)
        : "l"(a), "l"(b), "n"(TA));
  }
};

template <int TA>
struct Wgmma<48, TA> {
  static __device__ __forceinline__ void run(float (&d)[24], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, %26, 0;\n}\n"
        : ACC16(0), ACC8(16)
        : "l"(a), "l"(b), "n"(TA));
  }
};

template <int TA>
struct Wgmma<88, TA> {
  static __device__ __forceinline__ void run(float (&d)[44], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43}, "
        "%44, %45, p, 1, 1, %46, 0;\n}\n"
        : ACC16(0), ACC16(16), ACC8(32), ACC4(40)
        : "l"(a), "l"(b), "n"(TA));
  }
};

#undef ACC4
#undef ACC8
#undef ACC16

}  // namespace hopper
