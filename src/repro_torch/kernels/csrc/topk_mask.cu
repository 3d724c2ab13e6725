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
// What bounds it: each element is read once and written once (47.7 MB at
// Fedcom's P = 10, D = 595,914), so device memory bandwidth, as long as the
// select that finds each tile's threshold costs less than the tile's bytes.
// For non-negative floats the unsigned order of the bit pattern is the float
// order, +inf included, and a NaN's pattern (sign bit cleared) sorts above
// +inf, so the k-th largest magnitude is found exactly by a radix select on
// the 31 pattern bits.  The design:
//   * At most four passes over 8-bit digits, MSB first (bits 30-23, 22-15,
//     14-7, 6-0), not 31 passes over one bit.  Each pass builds a 256-bin
//     histogram in shared memory of the digits of the elements that match
//     the prefix decided so far; one warp scans the bins from the top for
//     the digit where the count reaches the remaining rank.  Two barriers a
//     pass.  The top digit is the exponent, so NaN and +inf land in bin 255.
//     Once the chosen bin holds at most 64 elements (after two digits a bin
//     of a normal tile holds one to three), they are gathered and ranked
//     directly, in place of the passes left.
//   * Magnitudes of one tile crowd into a few exponents, so in the first pass
//     most lanes of a warp hit one bin.  Each element still adds one by a
//     plain shared-memory atomic: aggregating a warp's lanes by digit
//     (__match_any_sync, one add per distinct digit) was measured slower
//     on the H100, even on tiles of one exponent (PERF.md §6).  The
//     counts are integers, so the histogram, and with it the threshold, is
//     the same whatever order the atomics land in; the gathered candidates'
//     ranks do not depend on their slots either: the result is bitwise
//     repeatable.
//   * One wave of blocks: the wrapper sizes the grid from the occupancy the
//     kernel gets, and each block walks tiles with a fixed stride.  Each
//     thread keeps its ITEMS = block_d / 256 elements (rounded up to a power
//     of two) in registers and issues the loads of its next tile before the
//     select of the current one, so a block's own loads overlap its select.
//   * Loads and stores are VEC floats wide (4, 2 or 1), as the wrapper picks
//     from D, block_d and the pointers' alignment.  At D = 595,914 a row
//     starts on an 8-byte boundary only (the stride is 2,383,656 B, 8 mod
//     16), so VEC is 2 there.  No bulk copy: TMA needs 16-byte-aligned
//     addresses and sizes, which every odd row and each row's last tile
//     (1,994 values) break, and a register tile needs no shared-memory
//     staging.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kMaxItems = 16;  // block_d <= kThreads * kMaxItems = 4096
constexpr uint32_t kInfBits = 0x7F800000u;
// a slot past block_d: its sign bit is set, so it matches no candidate prefix
constexpr uint32_t kAbsent = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
// after two or three digits, a bin this small is ranked directly
constexpr uint32_t kGather = 64;

// This thread's elements of tile t (row t / n_tiles, columns from
// (t % n_tiles)·block_d): positions (c * kThreads + tid) * VEC + e.  Pad
// columns (past D) and slots past block_d read as 0.  block_d, D and the
// tile's first column are multiples of VEC, so a group of VEC lies wholly
// inside or wholly outside.
template <int ITEMS, int VEC>
__device__ __forceinline__ void load_tile(const float* __restrict__ u, int64_t D, int n_tiles,
                                          int t, int block_d, int tid, float (&v)[ITEMS]) {
  const int64_t col0 = static_cast<int64_t>(t % n_tiles) * block_d;
  const float* __restrict__ src = u + (t / n_tiles) * D + col0;
#pragma unroll
  for (int c = 0; c < ITEMS / VEC; ++c) {
    const int j = (c * kThreads + tid) * VEC;
    float x[VEC];
    if (j < block_d && col0 + j < D) {
      flrce::load_vec<VEC>(src + j, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[c * VEC + e] = x[e];
  }
}

// Warp 0: the digit where the count, from the top bin down, reaches
// `remaining`, the rank left inside that bin and the bin's count, into
// decided[]; the bins are cleared as they are read, and *ncand too.  Lane l
// takes bins 255 - 8l - i, i = 0..7 (two 16-byte loads), then an inclusive
// scan over the lanes.
__device__ __forceinline__ void scan_bins(uint32_t* hist, uint32_t prefix, int shift,
                                          uint32_t remaining, uint32_t* decided, uint32_t* ncand) {
  const int lane = threadIdx.x & 31;
  uint4* h4 = reinterpret_cast<uint4*>(hist + kBins - 8 - 8 * lane);
  const uint4 lo = h4[0], hi = h4[1];
  h4[0] = make_uint4(0, 0, 0, 0);
  h4[1] = make_uint4(0, 0, 0, 0);
  const uint32_t c[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) sum += c[i];
  uint32_t incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  // the matching elements number at least `remaining`, so some lane hits
  if (lane == __ffs(__ballot_sync(kFull, incl >= remaining)) - 1) {
    uint32_t above = incl - sum;  // elements in the bins above this lane's
    uint32_t d = 0, r = 0, n = 0;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!found && above + c[i] >= remaining) {
        found = true;
        d = static_cast<uint32_t>(kBins - 1 - (lane * 8 + i));
        r = remaining - above;
        n = c[i];
      }
      above += c[i];
    }
    decided[0] = prefix | (d << shift);
    decided[1] = r;
    decided[2] = n;
    *ncand = 0;
  }
}

// Select and write the tile t held in cur: up to four digit passes, then the
// mask.  Every thread of the block calls it (it has barriers); hist is zero
// on entry and left zero.  `absent` has bit i set where this thread's
// element i lies past block_d.
template <int ITEMS, int VEC>
__device__ __forceinline__ void select_and_write(const float (&cur)[ITEMS], uint32_t absent,
                                                 float* __restrict__ out, int64_t D, int n_tiles,
                                                 int t, int block_d, int k, uint32_t* hist,
                                                 uint32_t* decided, uint32_t* cand,
                                                 uint32_t* ncand) {
  const int tid = threadIdx.x;
  uint32_t mag[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    mag[i] = ((absent >> i) & 1u) ? kAbsent : (__float_as_uint(cur[i]) & 0x7FFFFFFFu);
  }
  uint32_t prefix = 0;
  uint32_t remaining = static_cast<uint32_t>(k);  // rank among the elements matching prefix
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass < 3 ? 23 - 8 * pass : 0;  // digits: bits 30-23, 22-15, 14-7, 6-0
    const int high = 31 - 8 * pass;                  // the bits decided before this pass
    const uint32_t mask = pass < 3 ? 0xFFu : 0x7Fu;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if ((mag[i] >> high) == (prefix >> high)) atomicAdd(&hist[(mag[i] >> shift) & mask], 1u);
    }
    __syncthreads();
    if (tid < 32) scan_bins(hist, prefix, shift, remaining, decided, ncand);
    // decided[] is next written after the next pass's first barrier, which
    // every reader below has passed
    __syncthreads();
    prefix = decided[0];
    remaining = decided[1];
    const uint32_t count = decided[2];
    if ((pass == 1 || pass == 2) && count <= kGather) {
      // few elements share the prefix (after two digits a bin of a normal
      // tile holds one to three): gather them and rank them directly, in
      // place of the passes left.  Slots are taken in any order; the rank
      // of each candidate, and so the threshold, does not depend on it.
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if ((mag[i] >> shift) == (prefix >> shift)) cand[atomicAdd(ncand, 1u)] = mag[i];
      }
      __syncthreads();
      if (tid < count) {
        const uint32_t v = cand[tid];
        uint32_t above = 0, at_least = 0;
        for (uint32_t j = 0; j < count; ++j) {
          const uint32_t w = cand[j];
          above += w > v ? 1u : 0u;
          at_least += w >= v ? 1u : 0u;
        }
        if (above < remaining && remaining <= at_least) decided[0] = v;  // equal values, if more
      }
      __syncthreads();
      prefix = decided[0];
      break;
    }
  }

  const uint32_t kth = prefix;  // bit pattern of the k-th largest magnitude
  const bool kth_ok = kth <= kInfBits;
  const int64_t col0 = static_cast<int64_t>(t % n_tiles) * block_d;
  float* __restrict__ dst = out + (t / n_tiles) * D + col0;
#pragma unroll
  for (int c = 0; c < ITEMS / VEC; ++c) {
    const int j = (c * kThreads + tid) * VEC;
    if (j < block_d && col0 + j < D) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const uint32_t m = mag[c * VEC + e];
        o[e] = (kth_ok && m <= kInfBits && m >= kth) ? cur[c * VEC + e] : 0.0f;
      }
      flrce::store_vec<VEC>(dst + j, o);
    }
  }
}

template <int ITEMS, int VEC>
__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const float* __restrict__ u, float* __restrict__ out, int64_t D, int n_tiles,
                 int total, int block_d, int k) {
  __shared__ __align__(16) uint32_t hist[kBins];
  __shared__ uint32_t decided[3];  // prefix, remaining rank, count in the chosen bin
  __shared__ uint32_t cand[kGather];
  __shared__ uint32_t ncand;
  const int tid = threadIdx.x;
  hist[tid] = 0;  // kThreads == kBins; warp 0 clears the bins as it scans them
  uint32_t absent = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (((i / VEC) * kThreads + tid) * VEC + i % VEC >= block_d) absent |= 1u << i;
  }
  const int stride = gridDim.x;
  int t = blockIdx.x;
  // two register tiles in turn: the loads of tile t + stride go out into one
  // before the select of tile t in the other, and nothing waits on them
  // until that tile's own select
  float a[ITEMS], b[ITEMS];
  if (t < total) load_tile<ITEMS, VEC>(u, D, n_tiles, t, block_d, tid, a);
  __syncthreads();
  while (t < total) {
    if (t + stride < total) load_tile<ITEMS, VEC>(u, D, n_tiles, t + stride, block_d, tid, b);
    select_and_write<ITEMS, VEC>(a, absent, out, D, n_tiles, t, block_d, k, hist, decided, cand,
                                 &ncand);
    t += stride;
    if (t >= total) break;
    if (t + stride < total) load_tile<ITEMS, VEC>(u, D, n_tiles, t + stride, block_d, tid, a);
    select_and_write<ITEMS, VEC>(b, absent, out, D, n_tiles, t, block_d, k, hist, decided, cand,
                                 &ncand);
    t += stride;
  }
}

using TopkKernel = void (*)(const float*, float*, int64_t, int, int, int, int);

template <int ITEMS>
TopkKernel kernel_for_vec(int vec) {
  if (vec == 1) return topk_mask_kernel<ITEMS, 1>;
  if constexpr (ITEMS >= 2) {
    if (vec == 2) return topk_mask_kernel<ITEMS, 2>;
  }
  if constexpr (ITEMS >= 4) {
    if (vec == 4) return topk_mask_kernel<ITEMS, 4>;
  }
  return nullptr;
}

// The instance for block_d at load width vec, or null if there is none.
TopkKernel topk_kernel(int64_t block_d, int vec) {
  if (block_d < 1 || block_d > kThreads * kMaxItems || block_d % vec != 0) return nullptr;
  if (block_d <= kThreads) return kernel_for_vec<1>(vec);
  if (block_d <= 2 * kThreads) return kernel_for_vec<2>(vec);
  if (block_d <= 4 * kThreads) return kernel_for_vec<4>(vec);
  if (block_d <= 8 * kThreads) return kernel_for_vec<8>(vec);
  return kernel_for_vec<16>(vec);
}

}  // namespace

extern "C" {

// out (P, D) = block-local top-k mask of u (P, D), both contiguous fp32;
// 1 <= block_d <= 4096, 1 <= k <= block_d.  vec (1, 2 or 4) divides D and
// block_d, the pointers are 4·vec-byte aligned, and vec <= the instance's
// elements per thread.  `grid` blocks walk the P·ceil(D / block_d) tiles.
int flrce_topk_mask_rows(const float* u, float* out, int64_t P, int64_t D, int64_t block_d,
                         int64_t k, int32_t vec, int64_t grid, cudaStream_t stream) {
  const TopkKernel kernel = topk_kernel(block_d, vec);
  if (kernel == nullptr || P < 1 || D < 1 || k < 1 || k > block_d || D % vec != 0 || grid < 1 ||
      grid > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (D + block_d - 1) / block_d;
  // tile indices are int, and a block's index may run one grid past the last
  if (P * n_tiles + grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      u, out, D, static_cast<int>(n_tiles), static_cast<int>(P * n_tiles),
      static_cast<int>(block_d), static_cast<int>(k));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the (block_d, vec) instance an SM holds at once on the current
// device, and its registers a thread.
int flrce_topk_mask_occupancy(int64_t block_d, int32_t vec, int* blocks_per_sm, int* registers) {
  const TopkKernel kernel = topk_kernel(block_d, vec);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, 0));
}

}  // extern "C"
