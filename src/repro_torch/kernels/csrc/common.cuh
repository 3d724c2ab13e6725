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

}  // namespace flrce
