// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point takes raw device pointers, 64-bit sizes and the caller's
// stream, launches without synchronising, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flrce {

// VEC consecutive floats through the read-only path.  The caller guarantees
// the address is VEC*4-byte aligned (the wrapper picks VEC from the pointers'
// alignment and from D, so every row start stays aligned).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&x)[VEC]);

template <>
__device__ __forceinline__ void load_vec<1>(const float* __restrict__ p, float (&x)[1]) {
  x[0] = __ldg(p);
}

template <>
__device__ __forceinline__ void load_vec<2>(const float* __restrict__ p, float (&x)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  x[0] = t.x;
  x[1] = t.y;
}

template <>
__device__ __forceinline__ void load_vec<4>(const float* __restrict__ p, float (&x)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&x)[VEC]);

template <>
__device__ __forceinline__ void store_vec<1>(float* __restrict__ p, const float (&x)[1]) {
  p[0] = x[0];
}

template <>
__device__ __forceinline__ void store_vec<2>(float* __restrict__ p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

template <>
__device__ __forceinline__ void store_vec<4>(float* __restrict__ p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers that count the bytes of bulk copies into shared memory
// (cp.async.bulk ... mbarrier::complete_tx::bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared,
// counted on bar
__device__ __forceinline__ void bulk_to_shared(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// N bytes (16, 8 or 4; both addresses aligned to N) global -> shared by
// cp.async, of which only the first src_bytes are read and the rest are
// zeros.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, uint32_t src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(N), "r"(src_bytes)
                 : "memory");
  }
}

// cp.async groups: commit closes this thread's copies issued since the last
// commit into a group; wait_pending blocks until at most n of its groups
// are still in flight (n < 8).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

}  // namespace flrce
