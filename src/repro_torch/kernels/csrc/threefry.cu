// jax.random's Threefry-2x32 draws, bit for bit: standard normals (the
// models' initial weights) and QuantizedFL's keyed rounding uniforms.
//
// The reference has no Pallas kernel here: XLA draws jax.random.normal in
// TransformerLM.init (src/repro/models/layers.py dense_init / embed_init)
// and jax.random.uniform inside QuantizedFL's traced round
// (src/repro/fl/baselines/quantized.py update_transform).  With
// jax_threefry_partitionable=True element i of a draw is the 20-round
// Threefry-2x32 block of the key on the count pair (i >> 32, i & 0xffffffff),
// its words xor-ed, so one thread owns one count and no thread needs
// another's.
//
// What bounds it here: integer work.  One block is 72 32-bit adds, funnel
// rotations and xors (20 rounds of three, 5 key injections of two, the two
// initial adds); the uniform adds a shift, an or and a subtraction.  The
// 23.8 MB a CIFAR-width QuantizedFL round writes take 7 µs at 3.35 TB/s, its
// 5.96 M blocks about 30 µs at the INT32 units' rate.  The design keeps
// everything in registers: ITEMS counts a thread, strided by the block so
// the stores coalesce, no shared memory on the normal path; the rounding
// kernel derives each row's key from the device round index and client id
// once a block and each leaf's key once a block, not once an element.
//
// Bitwise agreement with the host (src/repro_torch/random.py, which mirrors
// XLA's CPU code): nvcc contracts a*b + c into an FMA by default, while XLA
// contracts only some pairs.  So every place the host rounds once
// (random._fma) is __fmaf_rn here, and every other float operation is
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, which nvcc
// never contracts or approximates.  No fast-math, no flushing of denormals;
// the constants are hexadecimal floats, exactly the host's float32 values.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kMaxBlockLeaves = 256;   // leaf keys a rounding block keeps in shared memory

__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                                              uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define FLRCE_TF_ROUND(r)               \
  x0 += x1;                             \
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
  FLRCE_TF_ROUND(13) FLRCE_TF_ROUND(15) FLRCE_TF_ROUND(26) FLRCE_TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  FLRCE_TF_ROUND(17) FLRCE_TF_ROUND(29) FLRCE_TF_ROUND(16) FLRCE_TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  FLRCE_TF_ROUND(13) FLRCE_TF_ROUND(15) FLRCE_TF_ROUND(26) FLRCE_TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  FLRCE_TF_ROUND(17) FLRCE_TF_ROUND(29) FLRCE_TF_ROUND(16) FLRCE_TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  FLRCE_TF_ROUND(13) FLRCE_TF_ROUND(15) FLRCE_TF_ROUND(26) FLRCE_TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef FLRCE_TF_ROUND
  return make_uint2(x0, x1);
}

// jax.random.fold_in(key, data): the count pair (0, data) under key
__device__ __forceinline__ uint2 fold_in(uint2 key, uint32_t data) {
  return threefry2x32(key.x, key.y, 0u, data);
}

// element `count` of _random_bits(key, 32, ·)
__device__ __forceinline__ uint32_t random_bits(uint2 key, uint64_t count) {
  const uint2 b = threefry2x32(key.x, key.y, static_cast<uint32_t>(count >> 32),
                               static_cast<uint32_t>(count));
  return b.x ^ b.y;
}

// float32 in [0, 1): the 23 high bits as the mantissa of [1, 2), minus 1
__device__ __forceinline__ float floats01(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// Cephes' logf for y > 0, as random._logf
__device__ __forceinline__ float logf_xla(float y) {
  const float tiny = 0x1p-126f;
  y = (y > tiny) ? y : tiny;
  const uint32_t bits = __float_as_uint(y);
  float e = __fadd_rn(__int2float_rn(static_cast<int>(bits >> 23) - 127), 1.0f);
  const float m = __uint_as_float((bits & 0x7FFFFFu) | 0x3F000000u);
  const bool low = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float y1 = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x, 0x1.de4a34p-4f);
  const float y2 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x, -0x1.555ca0p-3f);
  const float y3 = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x, 0x1.555554p-2f);
  float r = __fmaf_rn(__fmaf_rn(y1, x3, y2), x3, y3);
  r = __fmaf_rn(r, x3, __fmul_rn(e, -0x1.bd0106p-13f));
  return __fmaf_rn(e, 0x1.63p-1f, __fadd_rn(__fmaf_rn(-x2, 0.5f, x), r));
}

// XLA's float32 log1p, as random._log1p
__device__ __forceinline__ float log1p_xla(float x) {
  if (fabsf(x) >= 0x1.a8279ap-2f) return logf_xla(__fadd_rn(x, 1.0f));
  float p = 0x1.7bc096p-15f;
  float q = 1.0f;
  p = __fmaf_rn(p, x, 0x1.fe818ap-2f);  q = __fmaf_rn(q, x, 0x1.e2035ap+3f);
  p = __fmaf_rn(p, x, 0x1.a509f4p+2f);  q = __fmaf_rn(q, x, 0x1.4c30b6p+6f);
  p = __fmaf_rn(p, x, 0x1.de9738p+4f);  q = __fmaf_rn(q, x, 0x1.bb865ap+7f);
  p = __fmaf_rn(p, x, 0x1.e798ecp+5f);  q = __fmaf_rn(q, x, 0x1.351946p+8f);
  p = __fmaf_rn(p, x, 0x1.c8e75ap+5f);  q = __fmaf_rn(q, x, 0x1.b0db14p+7f);
  p = __fmaf_rn(p, x, 0x1.40a202p+4f);  q = __fmaf_rn(q, x, 0x1.e0f304p+5f);
  const float x2 = __fmul_rn(x, x);
  return __fadd_rn(x, __fmaf_rn(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q))));
}

// XLA's float32 erf_inv on the CPU (Giles' polynomials), as random.erf_inv
__device__ __forceinline__ float erf_inv_xla(float x) {
  const float w = -log1p_xla(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  const float ww = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? 0x1.e2cb1p-26f : -0x1.a3e136p-13f;
  p = __fmaf_rn(p, ww, lt ? 0x1.70966cp-22f : 0x1.a76ad6p-14f);
  p = __fmaf_rn(p, ww, lt ? -0x1.d8e6aep-19f : 0x1.61b8e4p-10f);
  p = __fmaf_rn(p, ww, lt ? -0x1.26b582p-18f : -0x1.e17bcep-9f);
  p = __fmaf_rn(p, ww, lt ? 0x1.ca65b6p-13f : 0x1.7824f6p-8f);
  p = __fmaf_rn(p, ww, lt ? -0x1.48a81p-10f : -0x1.f38baep-8f);
  p = __fmaf_rn(p, ww, lt ? -0x1.11c9dep-8f : 0x1.354afcp-7f);
  p = __fmaf_rn(p, ww, lt ? 0x1.f91ec6p-3f : 0x1.006db6p+0f);
  p = __fmaf_rn(p, ww, lt ? 0x1.805c5ep+0f : 0x1.6a9efcp+1f);
  return (fabsf(x) == 1.0f) ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

// jax.random.normal from one word: sqrt(2)·erf_inv(u), u uniform on
// (nextafter(-1, 0), 1) = max(lo, fma(f, hi - lo, lo))
__device__ __forceinline__ float normal_from_bits(uint32_t bits) {
  const float lo = -0x1.fffffep-1f;
  const float u = fmaxf(lo, __fmaf_rn(floats01(bits), __fsub_rn(1.0f, lo), lo));
  return __fmul_rn(0x1.6a09e6p+0f, erf_inv_xla(u));
}

__global__ void __launch_bounds__(kThreads)
threefry_normal_kernel(uint32_t k0, uint32_t k1, float* __restrict__ out, int64_t n) {
  const uint2 key = make_uint2(k0, k1);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t i = base + s * kThreads;
    if (i < n) out[i] = normal_from_bits(random_bits(key, static_cast<uint64_t>(i)));
  }
}

// Row k (blockIdx.y) of the (P, D) rounding uniforms, columns
// [blockIdx.x·kThreads·kItems, +kThreads·kItems): column j of leaf l is count
// j − offsets[l] of fold_in(fold_in(fold_in(base, t), ids[k]), l).
__global__ void __launch_bounds__(kThreads)
threefry_rounding_kernel(uint32_t k0, uint32_t k1, const int64_t* __restrict__ t,
                         const int64_t* __restrict__ ids, const int64_t* __restrict__ offsets,
                         int64_t n_leaves, float* __restrict__ out, int64_t D) {
  __shared__ int64_t s_off[kMaxBlockLeaves + 1];
  __shared__ uint2 s_key[kMaxBlockLeaves];
  __shared__ uint2 s_row;
  __shared__ int64_t s_first;
  __shared__ int s_count;
  const int64_t row = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * (kThreads * kItems);
  const int64_t c1 = (c0 + kThreads * kItems < D) ? c0 + kThreads * kItems : D;
  if (threadIdx.x == 0) {
    const uint2 key_t = fold_in(make_uint2(k0, k1), static_cast<uint32_t>(__ldg(t)));
    s_row = fold_in(key_t, static_cast<uint32_t>(__ldg(ids + row)));
    // leaves of c0 and c1 − 1: the number of offsets[1..L] at or below each
    int64_t lo = 0, hi = n_leaves;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (__ldg(offsets + 1 + mid) <= c0) lo = mid + 1; else hi = mid;
    }
    const int64_t first = lo;
    hi = n_leaves;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (__ldg(offsets + 1 + mid) <= c1 - 1) lo = mid + 1; else hi = mid;
    }
    s_first = first;
    const int64_t leaves = lo - first + 1;
    s_count = leaves > kMaxBlockLeaves ? kMaxBlockLeaves + 1 : static_cast<int>(leaves);
  }
  __syncthreads();
  const uint2 key_row = s_row;
  const int64_t first = s_first;
  const int count = s_count;
  float* __restrict__ dst = out + row * D;
  if (count <= kMaxBlockLeaves) {
    for (int l = threadIdx.x; l <= count; l += kThreads) {
      s_off[l] = __ldg(offsets + first + l);
      if (l < count) s_key[l] = fold_in(key_row, static_cast<uint32_t>(first + l));
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kItems; ++s) {
      const int64_t j = c0 + threadIdx.x + s * kThreads;
      if (j < c1) {
        int lo = 0, hi = count - 1;   // the last leaf whose offset is at or below j
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (s_off[mid] <= j) lo = mid; else hi = mid - 1;
        }
        dst[j] = floats01(random_bits(s_key[lo], static_cast<uint64_t>(j - s_off[lo])));
      }
    }
  } else {
    // more leaves than the shared arrays hold (tiny or empty leaves): each
    // element finds its leaf and derives its key itself
#pragma unroll 1
    for (int s = 0; s < kItems; ++s) {
      const int64_t j = c0 + threadIdx.x + s * kThreads;
      if (j < c1) {
        int64_t lo = 0, hi = n_leaves;
        while (lo < hi) {
          const int64_t mid = (lo + hi) / 2;
          if (__ldg(offsets + 1 + mid) <= j) lo = mid + 1; else hi = mid;
        }
        const uint2 key = fold_in(key_row, static_cast<uint32_t>(lo));
        dst[j] = floats01(random_bits(key, static_cast<uint64_t>(j - __ldg(offsets + lo))));
      }
    }
  }
}

}  // namespace

extern "C" {

// out (n,) = elements 0..n-1 of jax.random.normal(key (k0, k1)), float32
int flrce_threefry_normal(uint32_t k0, uint32_t k1, float* out, int64_t n, int64_t blocks,
                          cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  threefry_normal_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0, stream>>>(
      k0, k1, out, n);
  return static_cast<int>(cudaGetLastError());
}

// out (P, D): QuantizedFL's rounding uniforms of round t[0] for clients ids
// (P,), leaves at offsets (n_leaves + 1,), under the base key (k0, k1)
int flrce_threefry_rounding(uint32_t k0, uint32_t k1, const int64_t* t, const int64_t* ids,
                            const int64_t* offsets, int64_t n_leaves, float* out, int64_t P,
                            int64_t D, int64_t blocks, cudaStream_t stream) {
  if (blocks < 1 || blocks > 0x7FFFFFFF || P < 1 || P > 65535 || n_leaves < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(P));
  threefry_rounding_kernel<<<grid, dim3(kThreads), 0, stream>>>(k0, k1, t, ids, offsets,
                                                               n_leaves, out, D);
  return static_cast<int>(cudaGetLastError());
}

// registers, local (stack) bytes and resident blocks per SM of kernel
// `which` (0 normal, 1 rounding uniforms)
int flrce_threefry_attributes(int which, int* registers, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  const void* fn = which == 0 ? (const void*)threefry_normal_kernel
                              : (const void*)threefry_rounding_kernel;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0));
}

}  // extern "C"
