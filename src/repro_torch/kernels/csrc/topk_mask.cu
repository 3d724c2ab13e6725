// Block-local magnitude top-k mask of a (P, D) fp32 matrix (Fedcom's update
// compressor): per (row, block_d tile), keep the entries whose |u| is at least
// the tile's k-th largest |u| and write 0 elsewhere.
//
// Replaces the reference's Pallas kernel src/repro/kernels/topk_mask.py:
// topk_mask_rows (_topk_mask_kernel), which loads one (1, block_d) tile per
// grid step and finds the k-th magnitude with lax.top_k.
//
// Semantics kept bit for bit:
//   * columns past D are zero magnitudes that take part in the last tile's
//     threshold (the reference zero-pads D to a multiple of block_d); they
//     are neither read nor written;
//   * ties at the threshold are all kept;
//   * NaN ranks above +inf (as lax.top_k and torch.topk rank it), so it counts
//     toward k, but is never kept; a NaN threshold zeroes the whole tile;
//   * a kept value is written as it is (-0.0 stays -0.0), a dropped one as
//     +0.0.
//
// What bounds it here: it reads each element once and writes it once, a few
// integer operations per element per bit, so device memory bandwidth: 47.7 MB
// at Fedcom's P = 10, D = 595,914.  Design: one 256-thread block per (row,
// tile); each thread keeps its ITEMS = block_d / 256 elements (rounded up to
// a power of two, a compile-time size) and their magnitude bit patterns in
// registers.  For non-negative floats the unsigned order of the bit
// pattern is the float order, +inf included, and a NaN's pattern (sign bit
// cleared) sorts above +inf, so the k-th largest magnitude is found exactly
// by a radix select on the 31 pattern bits, MSB first: at each bit, count the
// elements that match the prefix decided so far and have the bit set (a warp
// reduction, then the eight warp counts in shared memory, one barrier per
// bit); keep the bit if that count reaches the remaining rank.  No atomics,
// so the result is bitwise repeatable.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 16;  // block_d <= kThreads * kMaxItems = 4096
constexpr uint32_t kInfBits = 0x7F800000u;
// a slot past block_d: its sign bit is set, so it matches no candidate prefix
constexpr uint32_t kAbsent = 0xFFFFFFFFu;

template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const float* __restrict__ u, float* __restrict__ out, int64_t D, int64_t n_tiles,
                 int block_d, int k) {
  __shared__ uint32_t warp_counts[2][kWarps];
  const int64_t row = blockIdx.x / n_tiles;
  const int64_t col0 = (blockIdx.x % n_tiles) * static_cast<int64_t>(block_d);
  const float* __restrict__ src = u + row * D;
  float* __restrict__ dst = out + row * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this thread's elements: tile positions tid + i * kThreads < block_d
  float val[ITEMS];
  uint32_t mag[ITEMS];
  bool in_tile[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = tid + i * kThreads;
    const int64_t col = col0 + j;
    in_tile[i] = j < block_d;
    val[i] = (in_tile[i] && col < D) ? __ldg(src + col) : 0.0f;  // pad: zero magnitude
    mag[i] = in_tile[i] ? (__float_as_uint(val[i]) & 0x7FFFFFFFu) : kAbsent;
  }

  uint32_t prefix = 0;
  int remaining = k;  // rank of the k-th largest among the elements matching prefix
  for (int bit = 30; bit >= 0; --bit) {
    const uint32_t cand = prefix | (1u << bit);
    const uint32_t high = ~((1u << bit) - 1u);  // the bits decided so far, and this one
    uint32_t c = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) c += ((mag[i] & high) == cand) ? 1u : 0u;
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    const int buf = bit & 1;
    if (lane == 0) warp_counts[buf][warp] = c;
    __syncthreads();
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_counts[buf][w];
    // the same decision in every thread: total is block-uniform.  The other
    // buffer is written next step, after a barrier every reader has passed.
    if (total >= static_cast<uint32_t>(remaining)) {
      prefix = cand;
    } else {
      remaining -= static_cast<int>(total);
    }
  }

  const uint32_t kth = prefix;  // bit pattern of the k-th largest magnitude
  const bool kth_ok = kth <= kInfBits;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int64_t col = col0 + tid + i * kThreads;
    if (in_tile[i] && col < D) {
      const bool keep = kth_ok && mag[i] <= kInfBits && mag[i] >= kth;
      dst[col] = keep ? val[i] : 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// out (P, D) = block-local top-k mask of u (P, D), both contiguous fp32;
// 1 <= block_d <= 4096, 1 <= k <= block_d.
int flrce_topk_mask_rows(const float* u, float* out, int64_t P, int64_t D, int64_t block_d,
                         int64_t k, cudaStream_t stream) {
  if (P < 1 || D < 1 || block_d < 1 || block_d > kThreads * kMaxItems || k < 1 || k > block_d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (D + block_d - 1) / block_d;
  if (P * n_tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(P * n_tiles));
  const int bd = static_cast<int>(block_d), kk = static_cast<int>(k);
  if (block_d <= kThreads) {
    topk_mask_kernel<1><<<grid, kThreads, 0, stream>>>(u, out, D, n_tiles, bd, kk);
  } else if (block_d <= 2 * kThreads) {
    topk_mask_kernel<2><<<grid, kThreads, 0, stream>>>(u, out, D, n_tiles, bd, kk);
  } else if (block_d <= 4 * kThreads) {
    topk_mask_kernel<4><<<grid, kThreads, 0, stream>>>(u, out, D, n_tiles, bd, kk);
  } else if (block_d <= 8 * kThreads) {
    topk_mask_kernel<8><<<grid, kThreads, 0, stream>>>(u, out, D, n_tiles, bd, kk);
  } else {
    topk_mask_kernel<16><<<grid, kThreads, 0, stream>>>(u, out, D, n_tiles, bd, kk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
