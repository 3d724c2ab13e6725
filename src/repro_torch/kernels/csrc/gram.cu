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
//
// gram (U Uᵀ, P <= 16) has a kernel of its own, gram_tri_kernel: at Alg. 3's
// shape (P = 10, D = 595,914) it reads 23.8 MB for 2·P²·D = 119 MFLOP, so it
// is bound by bytes, and the cross kernel with u = v wasted them: 12 U rows
// in registers for 10, every warp re-reading all of them through L1, the
// full square though the Gram is symmetric, and a second launch to sum the
// splits.  The design:
//  * Each thread reads its columns of the P rows once and accumulates the
//    PT(PT+1)/2 products of the upper triangle in fp32 FMA registers (no
//    TF32, no tensor cores).  PT in {4, 8, 12, 16} is a compile-time tile;
//    rows past P read the last valid row, and their sums are dropped (78
//    sums at P = 10, 55 kept, against 144 in the cross kernel).
//  * The rows stream by bulk copies (cp.async.bulk, completion counted on
//    an mbarrier a stage), one a row for each 512-column slab, into a
//    4-stage shared-memory ring: a few instructions move 20 KB, and the
//    bytes in flight take no registers, which the triangle's accumulators
//    need.  Bulk copies need 16-byte-aligned addresses and sizes, which the
//    odd rows (8 mod 16 at D = 595,914) lack, so each row's copy starts at
//    its 16-byte floor and the threads read it (r·D) mod 4 floats in; the
//    last whole 16-byte unit of the matrix bounds the last copy, and the
//    few columns past it are read from global memory.
//  * One launch: a one-wave grid of 256-thread blocks, planned from the
//    occupancy query (one block an SM at the P = 10 instance's registers,
//    so 132 splits), takes the slabs in turn: block b slabs b, b + 132, …,
//    so that at any moment the blocks read neighbouring slabs, P sliding
//    windows of the rows.  Each thread takes two columns of every slab.
//    A block reduces its triangle in a fixed order: a recursive-halving
//    exchange across the lanes (each step a lane keeps half of its sums and
//    sends the other half, so ~N shuffles for N sums, not 5N; compile-time
//    steps, so the sums stay in registers), then the warps in order through
//    shared memory, and writes it to a (n_splits, P(P+1)/2) scratch.
//    After a __threadfence each block adds one to an int32 arrival
//    counter; the last to arrive sums the splits (groups of its threads
//    take every G-th split, 40 loads at once, then the group sums in
//    order), writes out[i][j] and out[j][i] from the same value, so the
//    result is exactly symmetric, and sets the counter back to 0.  No float
//    atomics: repeated runs are bitwise identical.
//  * P > 16, or u not 16-byte aligned, takes the cross kernel with u = v
//    (two launches).
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


// ---------------------------------------------------------------------------
// gram_tri_kernel: U Uᵀ for P <= 16 in one launch (see the note above)
constexpr int kMaxTriRows = 16;
constexpr int kTriThreads = 256;
constexpr int kSlab = 2 * kTriThreads;  // columns a stage holds: two a thread
constexpr int kSlabRow = kSlab + 4;     // floats a row of a stage takes: 16-byte floor slack
constexpr int kStages = 4;              // slabs copied or in flight per block
constexpr int kSumBatch = 40;           // rows of partials a thread of the last block loads at once

template <int PT>
struct Tri {
  static constexpr int kSums = PT * (PT + 1) / 2;  // t = j(j+1)/2 + i for i <= j
  static constexpr int kPerLane = (kSums + 31) / 32;
  static constexpr int kPadded = 32 * kPerLane;
  static constexpr int kRingBytes = kStages * PT * kSlabRow * 4;
};
static_assert(kSlabRow * 4 % 16 == 0, "stage rows start 16-byte aligned");

// Rows per compile-time tile: the smallest of 4, 8, 12, 16 that holds P.
int tri_tile(int64_t P) { return P <= 4 ? 4 : P <= 8 ? 8 : P <= 12 ? 12 : P <= 16 ? 16 : 0; }

// The bulk copy of row r's n columns from column d: it starts at the
// row's 16-byte floor, `off` floats before column d, and moves whole 16-byte
// units; it stops at the last whole unit inside the matrix, so the last
// row's last columns may lie past `covered` (read from global instead).
struct RowCopy {
  const float* src;
  uint32_t bytes;
  int off;
  int covered;  // columns from d that the copy holds
};

__device__ __forceinline__ RowCopy row_copy(const float* u, int64_t D, int P, int r, int64_t d,
                                            int n) {
  const float* first = u + r * D + d;
  const uintptr_t at = reinterpret_cast<uintptr_t>(first);
  const uintptr_t floor16 = at & ~static_cast<uintptr_t>(15);
  const uintptr_t want = (at + 4u * n + 15u) & ~static_cast<uintptr_t>(15);
  const uintptr_t end = reinterpret_cast<uintptr_t>(u + P * D) & ~static_cast<uintptr_t>(15);
  const uintptr_t stop = want < end ? want : end;
  RowCopy c;
  c.src = reinterpret_cast<const float*>(floor16);
  c.bytes = static_cast<uint32_t>(stop - floor16);
  c.off = static_cast<int>((at - floor16) / 4);
  const int held = static_cast<int>(c.bytes / 4) - c.off;
  c.covered = held < n ? held : n;
  return c;
}

template <int PT, int N>
__device__ __forceinline__ void add_products(const float (&x)[PT][2], float (&acc)[N]) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < PT; ++j)
#pragma unroll
      for (int i = 0; i <= j; ++i)
        acc[j * (j + 1) / 2 + i] = fmaf(x[i][e], x[j][e], acc[j * (j + 1) / 2 + i]);
}

// One step of the recursive halving over acc[0, 2H): the lanes whose `bit`
// is set keep the upper half and send the lower; the sums land in acc[0, H).
// Compile-time sizes, so acc stays in registers.
template <int H, int BIT, int N>
__device__ __forceinline__ void halve(float (&acc)[N], int lane) {
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int s = 0; s < H; ++s) {
    const float send = upper ? acc[s] : acc[s + H];
    const float keep = upper ? acc[s + H] : acc[s];
    acc[s] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

template <int PT>
__global__ void __launch_bounds__(kTriThreads, 1)
gram_tri_kernel(const float* __restrict__ u, float* __restrict__ partial, int* __restrict__ arrival,
                float* __restrict__ out, int P, int64_t D) {
  constexpr int N = Tri<PT>::kPadded, M = Tri<PT>::kPerLane;
  constexpr int WARPS = kTriThreads / 32;
  extern __shared__ float4 smem4[];  // kStages x PT x kSlabRow floats
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float red[WARPS][N];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t split = blockIdx.x;
  const int64_t n_splits = gridDim.x;
  // block b takes slabs b, b + n_splits, …: the blocks stream neighbouring
  // slabs at any moment, so the rows are read as P sliding windows
  const int64_t slabs = (D + kSlab - 1) / kSlab;
  const int steps = static_cast<int>((slabs - split + n_splits - 1) / n_splits);
  const int T = P * (P + 1) / 2;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) flrce::mbar_init(full + s, 1);
    flrce::mbar_fence_init();
  }
  __syncthreads();
  // warp 0 copies slab `step` of the P rows into stage step % kStages, one
  // row a lane
  auto issue = [&](int step) {
    const int64_t d = (split + step * n_splits) * kSlab;
    const int n = static_cast<int>(D - d < kSlab ? D - d : kSlab);
    uint64_t* bar = full + step % kStages;
    RowCopy c{nullptr, 0, 0, 0};
    if (lane < P) c = row_copy(u, D, P, lane, d, n);
    const uint32_t total = __reduce_add_sync(0xffffffffu, c.bytes);
    if (lane == 0) flrce::mbar_arrive_expect_tx(bar, total);
    __syncwarp();
    if (c.bytes > 0) {
      flrce::bulk_to_shared(ring + (step % kStages * PT + lane) * kSlabRow, c.src, c.bytes, bar);
    }
  };
  if (warp == 0) {
    for (int s = 0; s < kStages && s < steps; ++s) issue(s);
  }
  // row r's copies start (r·D) mod 4 floats before their first column (u is
  // 16-byte aligned and a slab starts at a multiple of 4 columns): 2 bits a row
  uint32_t offs = 0;
#pragma unroll
  for (int r = 0; r < PT; ++r) {
    offs |= static_cast<uint32_t>(((r < P ? r : P - 1) * D) & 3) << (2 * r);
  }

  float acc[N];
#pragma unroll
  for (int s = 0; s < N; ++s) acc[s] = 0.0f;
  const int col = 2 * tid;  // this thread's columns of a slab: col, col + 1
  for (int step = 0; step < steps; ++step) {
    const int64_t d = (split + step * n_splits) * kSlab;
    const int n = static_cast<int>(D - d < kSlab ? D - d : kSlab);
    const float* stage = ring + step % kStages * PT * kSlabRow;
    flrce::mbar_wait(full + step % kStages, (step / kStages) & 1);
    float x[PT][2];
    if (d + kSlab + 3 < D) {  // a whole slab, every copy whole (see row_copy)
#pragma unroll
      for (int r = 0; r < PT; ++r) {
        // rows past P read the last valid row; their sums are dropped
        const int rr = r < P ? r : P - 1;
        const int off = static_cast<int>((offs >> (2 * r)) & 3u);
        const float* slab = stage + rr * kSlabRow + off;
        if ((off & 1) == 0) {
          const float2 v = *reinterpret_cast<const float2*>(slab + col);
          x[r][0] = v.x;
          x[r][1] = v.y;
        } else {
          x[r][0] = slab[col];
          x[r][1] = slab[col + 1];
        }
      }
    } else {  // the last slab: past n is 0; past a cut copy, from global
#pragma unroll
      for (int r = 0; r < PT; ++r) {
        const int rr = r < P ? r : P - 1;
        const RowCopy c = row_copy(u, D, P, rr, d, n);
        const float* slab = stage + rr * kSlabRow + c.off;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[r][e] = col + e >= n ? 0.0f
                    : col + e < c.covered ? slab[col + e]
                                          : __ldg(u + rr * D + d + col + e);
        }
      }
    }
    add_products<PT, N>(x, acc);
    __syncthreads();  // every thread is done with this stage
    if (warp == 0 && step + kStages < steps) issue(step + kStages);
  }

  // recursive halving: after the step of bit b a lane keeps the half of its
  // sums its bit selects and adds its partner's copy of that half; after five
  // steps lane l holds the warp's sums M·l .. M·l + M - 1
  halve<N / 2, 16>(acc, lane);
  halve<N / 4, 8>(acc, lane);
  halve<N / 8, 4>(acc, lane);
  halve<N / 16, 2>(acc, lane);
  halve<N / 32, 1>(acc, lane);
#pragma unroll
  for (int s = 0; s < M; ++s) red[warp][M * lane + s] = acc[s];
  __syncthreads();
  for (int t = tid; t < T; t += kTriThreads) {
    float s = red[0][t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w][t];
    partial[split * T + t] = s;
  }

  // the last block to arrive sums the (n_splits, T) partials: G groups of
  // threads, group g adding rows g, g + G, … of column t in turn, kSumBatch
  // loads at once (through L2: other blocks wrote them); then the G group
  // sums of each column in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(arrival, 1) == n_splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int G = kTriThreads / T;
  const int g = tid / T, t = tid % T;
  float* group_sums = &red[0][0];  // G·T <= kTriThreads <= WARPS·N floats
  if (g < G) {
    float s = 0.0f;
    for (int64_t r0 = g; r0 < n_splits; r0 += static_cast<int64_t>(G) * kSumBatch) {
      float x[kSumBatch];
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q) {
        const int64_t r = r0 + static_cast<int64_t>(q) * G;
        x[q] = r < n_splits ? __ldcg(partial + r * T + t) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kSumBatch; ++q) s += x[q];
    }
    group_sums[g * T + t] = s;
  }
  __syncthreads();
  if (tid < T) {
    float s = group_sums[tid];
    for (int q = 1; q < G; ++q) s += group_sums[q * T + tid];
    int j = 0;
    while ((j + 1) * (j + 2) / 2 <= tid) ++j;
    const int i = tid - j * (j + 1) / 2;
    out[i * P + j] = s;
    out[j * P + i] = s;
  }
  if (tid == 0) *arrival = 0;  // zero at rest for the next call
}

using TriKernel = void (*)(const float*, float*, int*, float*, int, int64_t);

// The PT instance and its ring bytes, its dynamic shared memory limit set
// once per device.
template <int PT>
cudaError_t tri_instance(TriKernel* kernel, int* smem) {
  static unsigned long long configured = 0;  // a bit per device
  *kernel = gram_tri_kernel<PT>;
  *smem = Tri<PT>::kRingBytes;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((configured >> dev) & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err == cudaSuccess && dev < 64) configured |= 1ull << dev;
  return err;
}

cudaError_t tri_kernel(int64_t P, TriKernel* kernel, int* smem) {
  switch (tri_tile(P)) {
    case 4: return tri_instance<4>(kernel, smem);
    case 8: return tri_instance<8>(kernel, smem);
    case 12: return tri_instance<12>(kernel, smem);
    case 16: return tri_instance<16>(kernel, smem);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (K, Q) = u (K, D) · v (Q, D)ᵀ; partial is (K, Q, n_splits) scratch.
int flrce_cross_gram(const float* u, const float* v, float* partial, float* out, int64_t K,
                     int64_t Q, int64_t D, int64_t n_splits, int64_t chunk, int vec,
                     cudaStream_t stream) {
  return launch_xgram(u, v, partial, out, K, Q, D, n_splits, chunk, vec, stream);
}

// out (P, P) = u (P, D) · u (P, D)ᵀ.  P <= 16, u 16-byte aligned:
// gram_tri_kernel in one launch of n_splits 256-thread blocks (at most one a
// 512-column slab), which take the slabs in turn; partial is (n_splits,
// P(P+1)/2) scratch and arrival one int32 zero, which the launch leaves at
// zero; chunk and vec are unused.  Otherwise the cross kernel with u = v
// over n_splits chunks of `chunk` columns at load width vec; partial is
// (P, P, n_splits) and arrival unused.
int flrce_gram(const float* u, float* partial, int* arrival, float* out, int64_t P, int64_t D,
               int64_t n_splits, int64_t chunk, int vec, cudaStream_t stream) {
  if (P > kMaxTriRows || reinterpret_cast<uintptr_t>(u) % 16 != 0) {
    return launch_xgram(u, u, partial, out, P, P, D, n_splits, chunk, vec, stream);
  }
  if (P < 1 || D < 1 || arrival == nullptr || n_splits < 1 ||
      n_splits > (D + kSlab - 1) / kSlab) {  // every block takes a slab
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TriKernel kernel;
  int smem = 0;
  const cudaError_t err = tri_kernel(P, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_splits), kTriThreads, smem, stream>>>(
      u, partial, arrival, out, static_cast<int>(P), D);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of gram_tri_kernel's instance for P <= 16 an SM holds at once on
// the current device, and its registers a thread.
int flrce_gram_occupancy(int64_t P, int* blocks_per_sm, int* registers) {
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  TriKernel kernel;
  int smem = 0;
  cudaError_t err = tri_kernel(P, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kTriThreads, smem));
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
