// Cross Gram U Vᵀ and Gram U Uᵀ in fp32 — FLrce's relationship ingest
// (Alg. 1 / Eq. 5-6: two cross Grams per round) and Alg. 3's conflict signs.
//
// Replaces the reference's Pallas kernels src/repro/kernels/gram.py:
// cross_gram (_xgram_kernel) and gram (_gram_kernel), which walk D in
// 2048-wide blocks on one TPU core and accumulate the (K, Q) tile in VMEM.
//
// What bounds it here: at the main path's shapes (K = 10 fresh updates,
// Q = 100 stored rows, D = 595,914) the kernel does 2·K·Q·D = 1.2 GFLOP but
// must read (K+Q)·D·4 B = 262 MB, so it is memory-bound (≈4.5 FLOP/B, far
// below the fp32 ridge).  The design therefore streams V exactly once from
// device memory and keeps everything else on chip:
//  * D is split across blocks (grid.x) so the card fills although K·Q is
//    small; each block also takes a tile of V rows (grid.y, 4 per warp, up
//    to 8 warps, fewer when Q is small) and a tile of KT <= 16 U rows
//    (grid.z).  flrce_xgram_plan sizes the split count so that the whole
//    grid is resident at once (one wave).
//  * Lanes walk consecutive columns (coalesced, VEC-wide loads where the
//    rows are aligned); U is re-read through L1 by the warps of a block and
//    stays L2-resident across the V tiles of a split.
//  * Every load of a step is unconditional (rows past Q or K re-read the
//    last valid row, and those sums are dropped at the store), and KT is a
//    compile-time size: a step issues all its loads before the first FMA
//    waits, instead of one memory round trip per U row.
//  * Each lane keeps a KTx4 fp32 accumulator tile in registers and uses
//    plain FMA: no TF32, no tensor cores, so the sums are fp32 like the
//    reference's preferred_element_type=f32.
//  * Each block writes its per-split partial sums into a (K, Q, n_splits)
//    buffer; a second pass gives each output one warp, whose lanes read the
//    splits contiguously and add them in a fixed order (strided lane sums,
//    then a fixed butterfly).  No atomics, so repeated runs are bitwise
//    identical.  Any D >= 1 (the ragged tail is masked per split), any K, Q.
#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kRowsPerWarp = 4;
// each lane of a block walks at least this many vectors of its D chunk
constexpr int kMinVecsPerLane = 4;

// U rows per block: the smallest compile-time tile that holds K (at most 16).
int k_tile(int64_t K) { return K <= 4 ? 4 : K <= 8 ? 8 : K <= 12 ? 12 : 16; }

// Warps per block: enough for Q rows at kRowsPerWarp each, at most kMaxWarps.
int block_warps(int64_t Q) {
  const int64_t w = (Q + kRowsPerWarp - 1) / kRowsPerWarp;
  return static_cast<int>(w < kMaxWarps ? w : kMaxWarps);
}

template <int VEC, int KT>
__global__ void __launch_bounds__(kMaxWarps * 32)
xgram_partial_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ partial, int64_t K, int64_t Q, int64_t D,
                     int64_t chunk) {
  const int64_t split = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t rows_per_block = static_cast<int64_t>(blockDim.x >> 5) * kRowsPerWarp;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * rows_per_block + warp * kRowsPerWarp;
  const int64_t k0 = static_cast<int64_t>(blockIdx.z) * KT;
  if (q0 >= Q) return;  // no rows for this warp; the kernel has no block-wide sync
  const int64_t d_begin = split * chunk;
  const int64_t d_end = (d_begin + chunk < D) ? d_begin + chunk : D;

  // rows past Q or K re-read the last valid row; their sums are dropped
  const float* vrow[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t q = (q0 + r < Q) ? q0 + r : Q - 1;
    vrow[r] = v + q * D;
  }
  const float* urow[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int64_t kk = (k0 + k < K) ? k0 + k : K - 1;
    urow[k] = u + kk * D;
  }

  float acc[KT][kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[k][r] = 0.f;

  for (int64_t d = d_begin + static_cast<int64_t>(lane) * VEC; d < d_end; d += 32 * VEC) {
    float vv[kRowsPerWarp][VEC];
    float uu[KT][VEC];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) flrce::load_vec<VEC>(vrow[r] + d, vv[r]);
#pragma unroll
    for (int k = 0; k < KT; ++k) flrce::load_vec<VEC>(urow[k] + d, uu[k]);
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[k][r] = fmaf(uu[k][e], vv[r][e], acc[k][r]);
  }

#pragma unroll
  for (int k = 0; k < KT; ++k) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float s = acc[k][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && k0 + k < K && q0 + r < Q) {
        partial[((k0 + k) * Q + q0 + r) * gridDim.x + split] = s;
      }
    }
  }
}

// One (VEC, KT) instance of the partial kernel, or null for other values.
using PartialKernel = void (*)(const float*, const float*, float*, int64_t, int64_t, int64_t,
                               int64_t);

template <int KT>
PartialKernel partial_for_vec(int vec) {
  switch (vec) {
    case 4: return xgram_partial_kernel<4, KT>;
    case 2: return xgram_partial_kernel<2, KT>;
    case 1: return xgram_partial_kernel<1, KT>;
    default: return nullptr;
  }
}

PartialKernel partial_kernel(int vec, int kt) {
  switch (kt) {
    case 4: return partial_for_vec<4>(vec);
    case 8: return partial_for_vec<8>(vec);
    case 12: return partial_for_vec<12>(vec);
    case 16: return partial_for_vec<16>(vec);
    default: return nullptr;
  }
}

// out[i] = sum over splits of partial[i][s], one warp per output, in a fixed
// order: lane l adds splits l, l+32, ... in turn, then a fixed butterfly.
constexpr int kSumWarps = 8;

__global__ void __launch_bounds__(kSumWarps * 32)
sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int64_t n_splits, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSumWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps leave together
  const float* row = partial + i * n_splits;
  float acc = 0.f;
  for (int64_t s = lane; s < n_splits; s += 32) acc += row[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[i] = acc;
}

int launch_xgram(const float* u, const float* v, float* partial, float* out, int64_t K,
                 int64_t Q, int64_t D, int64_t n_splits, int64_t chunk, int vec,
                 cudaStream_t stream) {
  const int kt = k_tile(K);
  const PartialKernel kernel = partial_kernel(vec, kt);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = block_warps(Q);
  const int64_t rows_per_block = static_cast<int64_t>(warps) * kRowsPerWarp;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>((Q + rows_per_block - 1) / rows_per_block),
                  static_cast<unsigned>((K + kt - 1) / kt));
  kernel<<<grid, warps * 32, 0, stream>>>(u, v, partial, K, Q, D, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t n = K * Q;
  sum_splits_kernel<<<static_cast<unsigned>((n + kSumWarps - 1) / kSumWarps), kSumWarps * 32, 0,
                      stream>>>(partial, out, n_splits, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (K, Q) = u (K, D) · v (Q, D)ᵀ; partial is (K, Q, n_splits) scratch.
int flrce_cross_gram(const float* u, const float* v, float* partial, float* out, int64_t K,
                     int64_t Q, int64_t D, int64_t n_splits, int64_t chunk, int vec,
                     cudaStream_t stream) {
  return launch_xgram(u, v, partial, out, K, Q, D, n_splits, chunk, vec, stream);
}

// out (P, P) = u (P, D) · u (P, D)ᵀ; its own entry point over the same kernel.
int flrce_gram(const float* u, float* partial, float* out, int64_t P, int64_t D,
               int64_t n_splits, int64_t chunk, int vec, cudaStream_t stream) {
  return launch_xgram(u, u, partial, out, P, P, D, n_splits, chunk, vec, stream);
}

// The split plan for out (K, Q) over D at load width vec: D cut into
// *n_splits chunks of *chunk columns, each a multiple of one warp's vector
// stride, with the grid (splits x row tiles x K tiles) as large as the
// current device holds at once and every lane still walking a few vectors.
// Returns a CUDA error code.
int flrce_xgram_plan(int64_t K, int64_t Q, int64_t D, int vec, int64_t* n_splits,
                     int64_t* chunk) {
  const int kt = k_tile(K);
  const PartialKernel kernel = partial_kernel(vec, kt);
  if (kernel == nullptr || K < 1 || Q < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = block_warps(Q);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * 32, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows_per_block = static_cast<int64_t>(warps) * kRowsPerWarp;
  const int64_t tiles = ((Q + rows_per_block - 1) / rows_per_block) * ((K + kt - 1) / kt);
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  const int64_t step = 32 * static_cast<int64_t>(vec);
  const int64_t want = resident / tiles > 0 ? resident / tiles : 1;
  const int64_t most_raw = (D + step * kMinVecsPerLane - 1) / (step * kMinVecsPerLane);
  const int64_t most = most_raw > 0 ? most_raw : 1;
  int64_t splits = want < most ? want : most;
  int64_t c = (D + splits - 1) / splits;
  c = (c + step - 1) / step * step;
  *chunk = c;
  *n_splits = (D + c - 1) / c;
  return 0;
}

const char* flrce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
