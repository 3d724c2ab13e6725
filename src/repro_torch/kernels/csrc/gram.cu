// Cross Gram U Vᵀ and Gram U Uᵀ in fp32 — FLrce's relationship ingest
// (Alg. 1 / Eq. 5-6: two cross Grams per round) and Alg. 3's conflict signs.
//
// Replaces the reference's Pallas kernels src/repro/kernels/gram.py:
// cross_gram (_xgram_kernel) and gram (_gram_kernel), which walk D in
// 2048-wide blocks on one TPU core and accumulate the (K, Q) tile in VMEM.
//
// cross_gram: out (K, Q) = U Vᵀ in one launch, any K, Q, D >= 1, by one of
// two kernels as K asks.  What bounds it: at the main path's shapes (K = 10
// fresh updates, Q = 100 stored rows, D = 595,914) it does 2·K·Q·D = 1.2
// GFLOP on (K+Q)·D·4 B = 262 MB, so bytes bound it; at the async round's
// K = 30 it does 3.6 GFLOP on 310 MB (0.053 ms at the fp32 peak against
// 0.092 ms for the bytes), and at K = 64 the two bounds meet.  So every
// input byte should cross device memory once, and at large K the FMAs must
// issue near their peak.  An SM feeds its FMA units from shared memory or
// L1 at 128 B a clock, 32 floats for 128 FMAs: a lane must reuse each
// float it loads about 4 times, so K > 16 needs register tiles of 8 x 8.
// Both kernels use fp32 FMA on the SIMT cores (no TF32, no tensor cores:
// the reference's preferred_element_type=f32).
//
// cross_gram_stream_kernel (K <= 16: the main path's, the fleet's and the
// LoRA rounds' ingest):
//  * D is split across blocks (grid.x) so that the card fills although
//    K·Q is small; each block also takes a tile of V rows (grid.y, 4 per
//    warp, up to 8 warps, fewer when Q is small) and all K rows of U.
//    kernels/gram.py plan_cross_gram sizes the split count from the
//    occupancy query so that the whole grid is resident at once.
//  * Lanes walk consecutive columns of their block's chunk (coalesced,
//    VEC-wide loads where the rows are aligned, every load of a step issued
//    before the first FMA waits); U is re-read through L1 by the warps of a
//    block and from L2 by the V tiles.  Each lane keeps a KT x 4 register
//    tile of sums, KT in {4, 8, 12, 16} the smallest that holds K.
//
// cross_gram_ring_kernel (K > 16: the async round's K = 30 ingest, and gram
// above 16 rows):
//  * A one-wave grid (occupancy query) whose blocks hold all K rows of U
//    (up to a 64-row tile; more K takes more tiles) and a tile of up to 128
//    rows of V (Q <= 128: one tile, so U and V each cross device memory
//    once; more Q re-reads U per tile, from L2 mostly, as neighbouring
//    blocks take the same slab).  Blocks take column slabs in turn: block b
//    slabs b, b + n, …
//  * Asynchronous copies into a ring of 3-8 stages, each one slab of every
//    row: every thread issues cp.async for its share of the slab's 16-byte
//    column quads, from a per-block table of row addresses, as one cp.async
//    group.  A step waits for its own group and passes one block barrier,
//    after which the slab has landed everywhere and the stage of the step
//    before is free for the next slab.  cp.async moves 16, 8 or 4 bytes as
//    the row's alignment allows, so every row lands 16-byte aligned in
//    shared memory whatever its address (at D = 595,914 the row pitch is 8
//    mod 16 bytes, which also rules out a 2-D tensor map), and zero-fills
//    the columns past D.  Stage rows take kRowPad floats past the slab: 8
//    banks between neighbouring rows, so that the loads below never collide.
//    Measured on the card before this layout: per-row bulk copies
//    (cp.async.bulk into mbarrier stages, one producer warp) and 256
//    mbarrier arrivals a step ran 2-3 times slower at 110-164 rows a stage.
//  * A lane holds an 8 x 8 register tile of (k, q) sums; the lanes of a
//    warp form 4 (k) x 4 (q) x 2 (column) groups, so a warp covers a 32 x 32
//    tile, and its U rows k, k + 4, … and V rows q, q + 4, … are read as
//    16-byte shared loads of 4 neighbouring rows and 8 columns each, without
//    bank conflicts: 256 FMAs for 16 loads.  The 8 or 12 warps of a block
//    (12, three a scheduler, hide the shared loads' latency better: K = 30
//    ran 10% faster on an H100) split the tile's k and q ranges and the
//    slab's columns.  Rows past K or Q read the last valid row; their sums
//    are dropped.
//  * u = v (gram above 16 rows): one copy of each slab serves both operands.
//
// Both reduce in the same launch, in a fixed order and without float
// atomics (finish_tile): each block writes its partial sums to a (tiles,
// n_splits, K·Q) scratch and adds one to its group's int32 arrival counter;
// the last of a group of ~sqrt(n_splits) blocks sums the group's partials
// in split order, and the last group to finish sums the group sums in order,
// writes out and sets the counters back to 0.  Results are bitwise
// repeatable on any stream; for u = v the (k, q) and (q, k) sums see the
// same products in the same order, so the result is exactly symmetric.
//
// gram_tri_kernel: U Uᵀ for P <= 16 with 16-byte-aligned data.  At Alg. 3's
// shape (P = 10, D = 595,914) it reads 23.8 MB for 2·P²·D = 119 MFLOP, so it
// is bound by bytes, and the Gram is symmetric: it sums only the upper
// triangle.  The design:
//  * Each thread reads its columns of the P rows once and accumulates the
//    PT(PT+1)/2 products of the upper triangle in fp32 FMA registers (no
//    TF32, no tensor cores).  PT in {4, 8, 12, 16} is a compile-time tile;
//    rows past P read the last valid row, and their sums are dropped (78
//    sums at P = 10, 55 kept).
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
//  * P > 16 takes cross_gram_ring_kernel, u not 16-byte aligned
//    cross_gram_stream_kernel, with u = v.
#include "common.cuh"

namespace {

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


// ---------------------------------------------------------------------------
// cross_gram: the ordered sum of the splits its two kernels end with
constexpr int kSplitBatch = 8;   // splits a thread loads at once while summing partials
constexpr int kSumOutputs = 4;   // outputs a thread sums at once

// Σ_{i < count} p[i·stride + t] for kSumOutputs outputs t = t0 + m·step (those
// below T), added in i order; through L2 (other blocks wrote p).
__device__ __forceinline__ void sum_in_order(const float* p, int64_t stride, int64_t count, int t0,
                                             int step, int T, float (&s)[kSumOutputs]) {
#pragma unroll
  for (int m = 0; m < kSumOutputs; ++m) s[m] = 0.0f;
  for (int64_t i0 = 0; i0 < count; i0 += kSplitBatch) {
    float x[kSumOutputs][kSplitBatch];
#pragma unroll
    for (int m = 0; m < kSumOutputs; ++m)
#pragma unroll
      for (int q = 0; q < kSplitBatch; ++q) {
        const int t = t0 + m * step;
        x[m][q] = (t < T && i0 + q < count) ? __ldcg(p + (i0 + q) * stride + t) : 0.0f;
      }
#pragma unroll
    for (int m = 0; m < kSumOutputs; ++m)
#pragma unroll
      for (int q = 0; q < kSplitBatch; ++q) {
        if (i0 + q < count) s[m] = i0 + q == 0 ? x[m][q] : s[m] + x[m][q];
      }
  }
}

// Once a block has written its partial sums of the tile's T outputs for
// split `split` (slot floats a split), after a fence: the last block of a
// group of `group` splits to arrive on the group's int32 counter sums the
// group's partials in split order into the group's first slot; the last
// group to finish sums those in group order and writes out[(k0 + t / qn) ·
// Q + q0 + t % qn].  Each counter is set back to 0 by the block that
// finishes it.  No float atomics, and the order of every sum is fixed.
__device__ __forceinline__ void finish_tile(float* tile_partial, int64_t slot, int T,
                                            int64_t n_splits, int group, int64_t split,
                                            int* arrival, int tile, float* out, int64_t Q,
                                            int64_t k0, int64_t q0, int qn) {
  const int tid = threadIdx.x, threads = blockDim.x;
  const int64_t n_groups = (n_splits + group - 1) / group;
  const int64_t g = split / group, first = g * group;
  const int64_t count = n_splits - first < group ? n_splits - first : group;
  int* counters = arrival + tile * (n_groups + 1);
  // once every thread has written and fenced, thread 0 arrives, and
  // __syncthreads_or hands its answer to the block without shared memory
  // (the stream kernel leaves all of it to L1)
  __threadfence();
  __syncthreads();
  if (!__syncthreads_or(tid == 0 && atomicAdd(counters + g, 1) == count - 1)) return;
  __threadfence();
  for (int t0 = tid; t0 < T; t0 += kSumOutputs * threads) {
    float sums[kSumOutputs];
    sum_in_order(tile_partial + first * slot, slot, count, t0, threads, T, sums);
#pragma unroll
    for (int m = 0; m < kSumOutputs; ++m) {
      const int t = t0 + m * threads;
      if (t < T) tile_partial[first * slot + t] = sums[m];
    }
  }
  if (tid == 0) counters[g] = 0;  // zero at rest for the next call
  __threadfence();
  __syncthreads();
  if (!__syncthreads_or(tid == 0 && atomicAdd(counters + n_groups, 1) == n_groups - 1)) return;
  __threadfence();
  for (int t0 = tid; t0 < T; t0 += kSumOutputs * threads) {
    float sums[kSumOutputs];
    sum_in_order(tile_partial, group * slot, n_groups, t0, threads, T, sums);
#pragma unroll
    for (int m = 0; m < kSumOutputs; ++m) {
      const int t = t0 + m * threads;
      if (t < T) out[(k0 + t / qn) * Q + q0 + t % qn] = sums[m];
    }
  }
  if (tid == 0) counters[n_groups] = 0;
}

// ---------------------------------------------------------------------------
// cross_gram_stream_kernel: U Vᵀ for K <= 16 (see the note above)
constexpr int kMaxStreamWarps = 8;
constexpr int kRowsPerWarp = 4;
// each lane of a block walks at least this many vectors of its D chunk
constexpr int kMinVecsPerLane = 4;

struct StreamArgs {
  int64_t K, Q, D, n_splits, chunk;
  int group;
};

template <int VEC, int KT>
__global__ void __launch_bounds__(kMaxStreamWarps * 32)
cross_gram_stream_kernel(const float* __restrict__ u, const float* __restrict__ v,
                         float* __restrict__ partial, int* __restrict__ arrival,
                         float* __restrict__ out, const StreamArgs a) {
  const int64_t split = blockIdx.x;
  const int tile = static_cast<int>(blockIdx.y);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows_per_block = static_cast<int>(blockDim.x >> 5) * kRowsPerWarp;
  const int64_t q0 = static_cast<int64_t>(tile) * rows_per_block;
  const int qn = static_cast<int>(a.Q - q0 < rows_per_block ? a.Q - q0 : rows_per_block);
  const int wq = warp * kRowsPerWarp;  // this warp's first row of the tile
  const int64_t slot = a.K * (a.Q < rows_per_block ? a.Q : rows_per_block);
  float* tile_partial = partial + static_cast<int64_t>(tile) * a.n_splits * slot;
  if (wq < qn) {  // warps past the tile's rows only join the sums
    const int64_t d_begin = split * a.chunk;
    const int64_t d_end = (d_begin + a.chunk < a.D) ? d_begin + a.chunk : a.D;
    // rows past Q or K re-read the last valid row; their sums are dropped
    const float* vrow[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      vrow[r] = v + (q0 + (wq + r < qn ? wq + r : qn - 1)) * a.D;
    }
    const float* urow[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) urow[k] = u + (k < a.K ? k : a.K - 1) * a.D;

    float acc[KT][kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < KT; ++k)
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[k][r] = 0.f;
    // every load of a step is issued before the first FMA waits, and two
    // steps unrolled keep the next step's loads in flight during this
    // step's FMAs (1.7 times faster at K = 10, Q = 100 on an H100)
#pragma unroll 2
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
        if (lane == 0 && k < a.K && wq + r < qn) tile_partial[split * slot + k * qn + wq + r] = s;
      }
    }
  }
  finish_tile(tile_partial, slot, static_cast<int>(a.K) * qn, a.n_splits, a.group, split, arrival,
              tile, out, a.Q, 0, q0, qn);
}

using StreamKernel = void (*)(const float*, const float*, float*, int*, float*, StreamArgs);

template <int KT>
StreamKernel stream_for_vec(int vec) {
  switch (vec) {
    case 4: return cross_gram_stream_kernel<4, KT>;
    case 2: return cross_gram_stream_kernel<2, KT>;
    case 1: return cross_gram_stream_kernel<1, KT>;
    default: return nullptr;
  }
}

// The (vec, kt) instance: load width 1/2/4 x U rows 4/8/12/16.
StreamKernel stream_kernel(int vec, int kt) {
  switch (kt) {
    case 4: return stream_for_vec<4>(vec);
    case 8: return stream_for_vec<8>(vec);
    case 12: return stream_for_vec<12>(vec);
    case 16: return stream_for_vec<16>(vec);
    default: return nullptr;
  }
}

// ---------------------------------------------------------------------------
// cross_gram_ring_kernel: U Vᵀ for K > 16 in one launch (see the note above)
constexpr int kRingMaxWarps = 12;  // a ring block's warps: 8 or 12 (three a scheduler)
constexpr int kMaxCrossStages = 8;
constexpr int kMaxCrossRows = 192;  // stage rows at most: 64 of U and 128 of V
constexpr int kRowPad = 8;       // floats a stage row takes past its slab: 8 banks between
                                 // neighbouring rows

// The launch plan (kernels/gram.py plan_cross_gram): tiles of kt U rows
// (wk warps of 4·RK) and qt V rows (wq warps of 4·RQ), n_kt x n_qt of them;
// the rest of the block's 8 or 12 warps split the slab's columns.  slab
// columns a stage, `stages` stages, n_splits blocks a tile taking the slabs
// in turn, summed in groups of `group`.  same: u is v, K = Q, one tile,
// one copy a row.
struct RingArgs {
  int64_t K, Q, D, n_splits;
  int kt, qt, n_kt, n_qt, wk, wq, slab, stages, group, same;
};

// Columns col .. col + 3 of a row of D into dst (16-byte aligned), by
// granules as wide as the row's alignment allows (`off`: the row's start in
// floats, mod 4; col is a multiple of 4), zeros past D.  A granule wholly
// past D reads nothing, from the row's start.
template <int W>
__device__ __forceinline__ void copy_granules(float* dst, const float* row, int64_t col,
                                              int64_t D) {
#pragma unroll
  for (int e = 0; e < 4 / W; ++e) {
    const int64_t c = col + e * W, n = D - c;
    const uint32_t bytes = n <= 0 ? 0u : n >= W ? 4u * W : static_cast<uint32_t>(4 * n);
    flrce::cp_async<4 * W>(dst + e * W, n > 0 ? row + c : row, bytes);
  }
}

__device__ __forceinline__ void copy_quad(float* dst, const float* row, int64_t col, int64_t D,
                                          int off) {
  if (off == 0) {
    copy_granules<4>(dst, row, col, D);
  } else if ((off & 1) == 0) {
    copy_granules<2>(dst, row, col, D);
  } else {
    copy_granules<1>(dst, row, col, D);
  }
}

template <int RK, int RQ>
__global__ void __launch_bounds__(kRingMaxWarps * 32, 1)
cross_gram_ring_kernel(const float* __restrict__ u, const float* __restrict__ v,
                  float* __restrict__ partial, int* __restrict__ arrival, float* __restrict__ out,
                  const RingArgs a) {
  extern __shared__ float4 smem4[];  // stages x rows x (slab + kRowPad) floats
  float* ring = reinterpret_cast<float*>(smem4);
  __shared__ const float* row_src[kMaxCrossRows];  // each stage row's matrix row
  __shared__ uint8_t row_off[kMaxCrossRows];       // its start in floats, mod 4
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = a.n_kt * a.n_qt;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const int64_t split = blockIdx.x / n_tiles;
  const int64_t k0 = static_cast<int64_t>(tile / a.n_qt) * a.kt;
  const int64_t q0 = static_cast<int64_t>(tile % a.n_qt) * a.qt;
  const int kn = static_cast<int>(a.K - k0 < a.kt ? a.K - k0 : a.kt);  // this tile's rows
  const int qn = static_cast<int>(a.Q - q0 < a.qt ? a.Q - q0 : a.qt);
  const int rows = a.same ? kn : kn + qn;  // stage rows: U's, then V's
  const int stride = a.slab + kRowPad;
  const int stage_floats = rows * stride;
  const int64_t slabs = (a.D + a.slab - 1) / a.slab;
  const int steps = static_cast<int>((slabs - split + a.n_splits - 1) / a.n_splits);

  const int warps = blockDim.x >> 5;
  for (int r = tid; r < rows; r += blockDim.x) {
    const float* row = r < kn ? u + (k0 + r) * a.D : v + (q0 + r - kn) * a.D;
    row_src[r] = row;
    row_off[r] = static_cast<uint8_t>((reinterpret_cast<uintptr_t>(row) / 4) & 3u);
  }
  __syncthreads();
  // each thread copies its share of slab t's rows into stage t % stages as
  // one cp.async group: a row's 16-byte column quads go to `per_row` lanes
  // of a warp, each warp taking 32 / per_row rows at a time
  const int quads = a.slab / 4;
  const int per_row = quads < 32 ? quads : 32;
  const int row_lanes = 32 / per_row;
  const int r0 = warp * row_lanes + lane / per_row, rstep = warps * row_lanes;
  const int qlane = lane % per_row;
  auto issue = [&](int t) {
    const int64_t d = (split + static_cast<int64_t>(t) * a.n_splits) * a.slab;
    float* stage = ring + (t % a.stages) * stage_floats;
    const bool whole = d + a.slab <= a.D;
    for (int r = r0; r < rows; r += rstep) {
      const float* src = row_src[r] + d;
      const int off = row_off[r];
      float* dst = stage + r * stride;
      if (!whole) {
        for (int q = qlane; q < quads; q += per_row) {
          copy_quad(dst + 4 * q, row_src[r], d + 4 * q, a.D, off);
        }
      } else if (off == 0) {
        for (int q = qlane; q < quads; q += per_row) {
          flrce::cp_async<16>(dst + 4 * q, src + 4 * q, 16);
        }
      } else if ((off & 1) == 0) {
        for (int q = qlane; q < quads; q += per_row) {
          flrce::cp_async<8>(dst + 4 * q, src + 4 * q, 8);
          flrce::cp_async<8>(dst + 4 * q + 2, src + 4 * q + 2, 8);
        }
      } else {
        for (int q = qlane; q < quads; q += per_row) {
#pragma unroll
          for (int e = 0; e < 4; ++e) flrce::cp_async<4>(dst + 4 * q + e, src + 4 * q + e, 4);
        }
      }
    }
    flrce::cp_async_commit();
  };
  // slabs 0 .. stages - 2 in flight before the first step; step t waits for
  // its slab, then (one barrier: every thread is past step t - 1) refills the
  // stage of slab t - 1 with slab t + stages - 1
  for (int t = 0; t < a.stages - 1 && t < steps; ++t) issue(t);

  // lane = kg + 4·qg + 16·cg; warp = wk + WK·(wq + WQ·wc)
  const int kg = lane & 3, qg = (lane >> 2) & 3, cg = lane >> 4;
  const int wk = warp % a.wk, wq = (warp / a.wk) % a.wq, wc = warp / (a.wk * a.wq);
  const int wcs = warps / (a.wk * a.wq);
  // this thread's rows as stage offsets; rows past K or Q read the last one
  int uo[RK], vo[RQ];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int want = wk * 4 * RK + kg + 4 * i;
    uo[i] = (want < kn ? want : kn - 1) * stride;
  }
#pragma unroll
  for (int j = 0; j < RQ; ++j) {
    const int want = wq * 4 * RQ + qg + 4 * j;
    const int ql = want < qn ? want : qn - 1;
    vo[j] = (a.same ? ql : kn + ql) * stride;
  }

  float acc[RK][RQ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RQ; ++j) acc[i][j] = 0.0f;
  const int lc = cg + 2 * wc, lcs = 2 * wcs;  // this thread's quads: lc, lc + lcs, …
  for (int step = 0; step < steps; ++step) {
    const int issued = steps < step + a.stages - 1 ? steps : step + a.stages - 1;
    flrce::cp_async_wait_pending(issued - step - 1);
    __syncthreads();  // slab `step` has landed everywhere; stage (step - 1) % stages is free
    if (step + a.stages - 1 < steps) issue(step + a.stages - 1);
    const float* stage = ring + (step % a.stages) * stage_floats;
    for (int g = lc; g < quads; g += lcs) {
      const float* at = stage + 4 * g;
      float4 x[RK], y[RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) x[i] = *reinterpret_cast<const float4*>(at + uo[i]);
#pragma unroll
      for (int j = 0; j < RQ; ++j) y[j] = *reinterpret_cast<const float4*>(at + vo[j]);
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
        }
    }
  }
  __syncthreads();  // every thread is done with the ring

  // the two column lanes, then the column warps in order through shared
  // memory (the ring is free: every copy has landed and been read)
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < RQ; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
  float* red = ring;  // wcs x kt x qt
  const int tile_floats = a.kt * a.qt;
  if (cg == 0) {
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) {
        red[wc * tile_floats + (wk * 4 * RK + kg + 4 * i) * a.qt + wq * 4 * RQ + qg + 4 * j] =
            acc[i][j];
      }
  }
  __syncthreads();
  const int T = kn * qn;
  const int64_t slot = (a.K < a.kt ? a.K : a.kt) * (a.Q < a.qt ? a.Q : a.qt);
  float* tile_partial = partial + static_cast<int64_t>(tile) * a.n_splits * slot;
  for (int t = tid; t < T; t += blockDim.x) {
    const int at = (t / qn) * a.qt + t % qn;
    float sum = red[at];
    for (int w = 1; w < wcs; ++w) sum += red[w * tile_floats + at];
    tile_partial[split * slot + t] = sum;
  }

  finish_tile(tile_partial, slot, T, a.n_splits, a.group, split, arrival, tile, out, a.Q, k0, q0,
              qn);
}

using RingKernel = void (*)(const float*, const float*, float*, int*, float*, RingArgs);

// The one compiled instance: a lane holds 8 x 8 sums, so a warp a 32 x 32
// tile (two warps over K past 32 rows).
constexpr int kRingRK = 8, kRingRQ = 8;

// The instance, its dynamic shared memory limit raised once per device to
// what the card lets a block have beside its static shared memory.
cudaError_t ring_instance(RingKernel* kernel, int* smem_max) {
  static unsigned long long configured = 0;  // a bit per device
  static int limit[64] = {};
  *kernel = cross_gram_ring_kernel<kRingRK, kRingRQ>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((configured >> dev) & 1ull)) {
    *smem_max = limit[dev];
    return cudaSuccess;
  }
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, *kernel);
  if (err != cudaSuccess) return err;
  *smem_max = optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_max);
  if (err == cudaSuccess && dev < 64) {
    limit[dev] = *smem_max;
    configured |= 1ull << dev;
  }
  return err;
}

}  // namespace

extern "C" {

// out (K, Q) = u (K, D) · v (Q, D)ᵀ for K <= 16 in one launch of
// cross_gram_stream_kernel, as kernels/gram.py plan_cross_gram lays it out:
// the (vec, kt) instance (vec: the widest load every row start allows),
// blocks of `warps` warps over 4·warps V rows (⌈Q / 4·warps⌉ tiles), D cut
// into n_splits chunks of `chunk` columns (a multiple of 32·vec), the
// splits summed in groups of `group`.  partial is (tiles, n_splits, K ·
// min(Q, 4·warps)) scratch, arrival tiles · (⌈n_splits / group⌉ + 1) int32
// zeros, which the launch leaves at zero.
int flrce_cross_gram_stream(const float* u, const float* v, float* partial, int* arrival,
                            float* out, int64_t K, int64_t Q, int64_t D, int kt, int vec,
                            int warps, int64_t n_splits, int64_t chunk, int group,
                            cudaStream_t stream) {
  const StreamKernel kernel = stream_kernel(vec, kt);
  if (kernel == nullptr || K < 1 || K > kt || Q < 1 || D < 1 || warps < 1 ||
      warps > kMaxStreamWarps || n_splits < 1 || chunk < 1 || chunk % (32 * vec) != 0 ||
      n_splits * chunk < D || (n_splits - 1) * chunk >= D || group < 1 || arrival == nullptr ||
      D % vec != 0 || reinterpret_cast<uintptr_t>(u) % (4 * vec) != 0 ||
      reinterpret_cast<uintptr_t>(v) % (4 * vec) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t rows_per_block = static_cast<int64_t>(warps) * kRowsPerWarp;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>((Q + rows_per_block - 1) / rows_per_block));
  kernel<<<grid, warps * 32, 0, stream>>>(u, v, partial, arrival, out,
                                          StreamArgs{K, Q, D, n_splits, chunk, group});
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the (vec, kt) instance of cross_gram_stream_kernel at `warps`
// warps a block that an SM holds at once, and its registers a thread.
int flrce_cross_gram_stream_occupancy(int vec, int kt, int warps, int* blocks_per_sm,
                                      int* registers) {
  const StreamKernel kernel = stream_kernel(vec, kt);
  if (kernel == nullptr || warps < 1 || warps > kMaxStreamWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, warps * 32, 0));
}

// out (K, Q) = u (K, D) · v (Q, D)ᵀ for K > 16 in one launch of
// cross_gram_ring_kernel, as kernels/gram.py plan_cross_gram lays it out:
// blocks of wk x wq x wc warps (8 or 12 in all) over tiles of wk·32 U rows
// and wq·32 V rows and the slab's columns, slabs of `slab` columns (a
// multiple of 32) in `stages` stages of `smem` bytes in all, n_splits
// blocks a tile summed in groups of `group`.  partial is (tiles, n_splits,
// min(K, kt) · min(Q, qt)) scratch, arrival tiles · (⌈n_splits / group⌉ +
// 1) int32 zeros, which the launch leaves at zero.  same: u is v (K = Q,
// one tile), and each slab is copied once for both operands.
int flrce_cross_gram_ring(const float* u, const float* v, float* partial, int* arrival, float* out,
                          int64_t K, int64_t Q, int64_t D, int wk, int wq, int wc, int slab,
                          int stages, int64_t n_splits, int group, int smem, int same,
                          cudaStream_t stream) {
  const int warps = wk * wq * wc;
  if (K < 1 || Q < 1 || D < 1 || wk < 1 || wq < 1 || wc < 1 || (warps != 8 && warps != 12) ||
      slab < 32 || slab % 32 != 0 || stages < 2 || stages > kMaxCrossStages || group < 1 ||
      arrival == nullptr || reinterpret_cast<uintptr_t>(u) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingArgs a{K, Q, D, n_splits, wk * 4 * kRingRK, wq * 4 * kRingRQ, 0, 0, wk, wq, slab, stages,
              group, same ? 1 : 0};
  a.n_kt = static_cast<int>((K + a.kt - 1) / a.kt);
  a.n_qt = static_cast<int>((Q + a.qt - 1) / a.qt);
  const int64_t slabs = (D + slab - 1) / slab;
  const int64_t kn = K < a.kt ? K : a.kt, qn = Q < a.qt ? Q : a.qt;
  const int64_t rows = same ? kn : kn + qn;
  const int64_t need_ring = static_cast<int64_t>(stages) * rows * (slab + kRowPad) * 4;
  const int64_t need_red = static_cast<int64_t>(wc) * a.kt * a.qt * 4;
  if (n_splits < 1 || n_splits > slabs || rows > kMaxCrossRows || smem < need_ring ||
      smem < need_red || (same && (u != v || K != Q || a.n_kt != 1 || a.n_qt != 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RingKernel kernel;
  int smem_max = 0;
  const cudaError_t err = ring_instance(&kernel, &smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(a.n_kt) * a.n_qt * n_splits;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(u, v, partial, arrival, out,
                                                                      a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of cross_gram_ring_kernel at `warps` warps an SM holds at once
// with `smem` bytes of dynamic shared memory, its registers a thread, and
// the most dynamic shared memory a block of it may take.
int flrce_cross_gram_ring_occupancy(int warps, int smem, int* blocks_per_sm, int* registers,
                                    int* smem_max) {
  if (warps < 1 || warps > kRingMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  RingKernel kernel;
  cudaError_t err = ring_instance(&kernel, smem_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  if (smem > *smem_max) {
    *blocks_per_sm = 0;
    return 0;
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, warps * 32, smem));
}

// out (P, P) = u (P, D) · u (P, D)ᵀ for P <= 16 and u 16-byte aligned:
// gram_tri_kernel in one launch of n_splits 256-thread blocks (at most one a
// 512-column slab), which take the slabs in turn; partial is (n_splits,
// P(P+1)/2) scratch and arrival one int32 zero, which the launch leaves at
// zero.  Other P or data take a cross_gram kernel with u = v.
int flrce_gram(const float* u, float* partial, int* arrival, float* out, int64_t P, int64_t D,
               int64_t n_splits, cudaStream_t stream) {
  if (P < 1 || P > kMaxTriRows || reinterpret_cast<uintptr_t>(u) % 16 != 0 || D < 1 ||
      arrival == nullptr || n_splits < 1 ||
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

const char* flrce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
