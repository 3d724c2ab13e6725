// One-query GQA attention over a KV cache (flash-decoding), bf16 or fp32,
// written for Hopper: one launch, K/V rows streamed by bulk copies into a
// shared-memory ring, a grid of at most one wave.
//
// Replaces the reference's Pallas kernel src/repro/kernels/decode_attention.py:86
// decode_attention (_decode_attn_kernel), and covers the window / ring masks of
// decode_attention_jnp (src/repro/models/attention.py:176), the function the
// reference's serving path calls.  For q (B, H, hd), caches (B, S, K, hd) and
// length (B,), with G = H / K query heads per KV head (any G up to 16):
//   * valid slots: ring: s < min(length, S); otherwise s < length, and with
//     window > 0 also s >= length - window.  Either way a contiguous range
//     [lo, hi) of slots;
//   * logits = (q·(1/sqrt(hd)) in fp32) · K in fp32, softmax over the valid
//     slots, out = Σ p·V in fp32, written in q's dtype;
//   * an empty range (length 0): the reference masks every logit to -1e30,
//     so its softmax is uniform over all S slots and the output is the mean of
//     V over the whole cache.  The kernel computes exactly that.
// Masked logits contribute exactly 0 in the reference (exp(-1e30 - m)
// underflows), so skipping those slots changes nothing, and no byte outside
// [lo, hi) is read (V at length 0 aside).
//
// What bounds it: each K/V row is read once and used for 2·G flops per
// element, about 2 flops per byte at G = 2 in bf16, so device memory
// bandwidth: the least time is the valid K/V bytes over the card's bandwidth.
// To stay at that rate the card needs some 3 MB in flight at every moment
// (3.35 TB/s times about a microsecond of latency), 20-odd KB per SM, with no
// gap.  What the design does about it:
//   * split-S: one 128-thread block per (split of the valid range, KV head,
//     sequence); the G query heads of a KV head share the block, so each K/V
//     row is read once for all of them.  A block holds its heads' q and
//     accumulators in registers, G·hd/32 floats a lane each, and at hd 256
//     an instance takes 126 registers at G = 4 and 218 at G = 8: a ninth
//     head would pass the 255-register ceiling and spill.  So a group of
//     9..16 heads (recurrentgemma-2b's MQA has 10) is cut into n_sub = 2
//     sub-groups of GS = ceil(G / 2) heads, each a block of its own on a
//     grid axis K·n_sub (the last sub-group of an odd G carries one dummy
//     head with q = 0, whose output is not written); such a KV head's rows
//     are read by both blocks, the second time mostly from L2.  A group of
//     at most 8 is one sub-group, as before.  The wrapper plans the split count
//     from the occupancy this kernel really gets (flrce_decode_attention_
//     occupancy): B·K·n_splits blocks fill at most one wave of resident
//     blocks, so no block waits for a second wave;
//   * each of the 4 warps owns a ring of kStages slots in shared memory and
//     feeds it itself: its lanes issue one cp.async.bulk per cache row
//     (hd·sizeof(T) contiguous bytes at stride K·hd) for K and for V,
//     completion counted on the slot's mbarrier (complete_tx::bytes).  The
//     warp refills a slot as soon as it has computed on it, so the next slot
//     is in flight while it works, and no registers or instructions are
//     spent on the copies.  A ring per warp needs no "empty" barriers and no
//     producer warp: the warp that reads a slot is the one that refills it,
//     after a __syncwarp.  Two slots of 4 KB a warp (32 KB a block) let 5
//     blocks of the serve instance share an SM, 80-160 KB in flight there;
//     on the card this beat 3 slots of 4 KB (4 blocks an SM), 4 of 4 KB (3)
//     and 8 of 4 KB (1) at the ring layer's shape by 6-17% on an H100, and
//     stayed within 1.5% of the best at a 32k cache.  1-D bulk copies and not a 2-D tensor map,
//     because every layer's cache has its own base pointer and a tensor map
//     would cost a host-side encode on every call of a host-bound step;
//   * compute from shared memory keeps the register mapping of a row: lane i
//     holds elements [c·32·VEC + i·VEC, +VEC) of it (16 bytes at most, so a
//     warp reads a row without bank conflicts), a dot product ends in a
//     5-step shuffle reduction, and each warp keeps its own running
//     (m, l, acc[G][hd/32]) with one rescale per RS rows (fewer where G
//     crowds the registers);
//   * one launch: the warps combine in shared memory (the drained rings
//     reused), each block writes its (m, l, acc) partial, and the last block
//     of a (sequence, KV head) to arrive on its int32 counter (__threadfence,
//     then atomicAdd, as in the CUDA samples' threadFenceReduction) combines
//     the partials in split order 0..n-1, divides by max(l, 1e-30) as the
//     Pallas kernel does, writes the output and sets the counter back to 0.
//     The counters and partials are kept per (sequence, KV head, sub-group).
//     With one split the block writes the output itself.  The order of every
//     sum is fixed, whichever block comes last: the result is bitwise
//     repeatable.
#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;                  // warps per block, each with its own ring
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;                 // ring slots per warp
constexpr int kWarpRingBytes = 8 * 1024;   // K and V bytes of one warp's ring
// the mbarriers and the last-block flag, rounded up to keep the rings 128-byte aligned
constexpr int kHeaderBytes = 128 * ((kWarps * kStages * 8 + 16 + 127) / 128);
constexpr int kMinRows = 64;               // fewest rows a split takes
constexpr int kMaxSplits = 512;            // splits the last block combines at most
constexpr int kMaxBlockGroup = 8;          // query heads a block holds at most (instances G 1..8)
constexpr int kMaxGroup = 16;              // query heads per KV head at most: two sub-groups

constexpr int max3(int a, int b, int c) { return a > b ? (a > c ? a : c) : (b > c ? b : c); }

// rows between two rescales: the x[RS][G] logits stay in registers.  Two at
// G = 5, the sub-groups of recurrentgemma-2b's 10 heads: faster than one at
// its ring layer's shape (chip_smoke.py --decode-variants, PERF.md)
constexpr int rows_per_step(int g, int r) {
  const int s = g == 1 ? 8 : g == 2 ? 4 : g <= 5 ? 2 : 1;
  return s < r ? s : r;
}

template <typename T, int HD, int G>
struct Shape {
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int R = kWarpRingBytes / (kStages * 2 * kRowBytes);  // rows per ring slot
  static constexpr int EPL = HD / 32;                                   // elements per lane
  static constexpr int VEC = EPL < 16 / (int)sizeof(T) ? EPL : 16 / (int)sizeof(T);
  static constexpr int CHUNKS = EPL / VEC;
  static constexpr int RS = rows_per_step(G, R);
  // the rings, and once they drain, the warps' (acc, m, l) or the last
  // block's (m, l) of every split and its denominators
  static constexpr int kScratchBytes = max3(kWarps * kWarpRingBytes,
                                            kWarps * G * HD * 4 + 2 * kWarps * G * 4,
                                            2 * kMaxSplits * G * 4 + G * 4);
  static constexpr int kSmemBytes = kHeaderBytes + kScratchBytes;  // 32,896 at G = 2, hd 256
  static_assert(R >= 1 && R <= 32 && R % RS == 0, "ring slot rows");
  static_assert(kRowBytes % 16 == 0, "bulk copies move multiples of 16 bytes");
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ void bf16x2(uint32_t u, float& a, float& b) {
  a = __uint_as_float(u << 16);  // the first element is the low half
  b = __uint_as_float(u & 0xFFFF0000u);
}

// VEC consecutive elements at p (aligned to VEC elements) as floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* x) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      x[0] = t.x;
      x[1] = t.y;
    } else {
      static_assert(VEC == 4, "fp32 VEC is 2 or 4");
      const float4 t = *reinterpret_cast<const float4*>(p);
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
    }
  } else {
    if constexpr (VEC == 2) {
      bf16x2(*reinterpret_cast<const uint32_t*>(p), x[0], x[1]);
    } else if constexpr (VEC == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      bf16x2(u.x, x[0], x[1]);
      bf16x2(u.y, x[2], x[3]);
    } else {
      static_assert(VEC == 8, "bf16 VEC is 2, 4 or 8");
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      bf16x2(u.x, x[0], x[1]);
      bf16x2(u.y, x[2], x[3]);
      bf16x2(u.z, x[4], x[5]);
      bf16x2(u.w, x[6], x[7]);
    }
  }
}

// this lane's EPL elements of a row: chunk c holds [c·32·VEC + lane·VEC, +VEC)
template <typename T, int VEC, int CHUNKS>
__device__ __forceinline__ void load_lane(const T* row, int lane, float* x) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) load_vec<T, VEC>(row + c * 32 * VEC + lane * VEC, x + c * VEC);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the valid slot range [lo, hi) of one sequence
__device__ __forceinline__ void valid_range(int len, int S, int window, int ring, int& lo, int& hi) {
  hi = min(len, S);
  lo = (!ring && window > 0) ? max(0, len - window) : 0;
  if (hi < lo) hi = lo;
}

// every logit masked: the reference's softmax is uniform over all S slots,
// so each of the G heads gets the mean of V over the whole cache
template <typename T, int HD, int G>
__device__ __forceinline__ void mean_of_v(const T* __restrict__ vb, int S, int64_t row_stride, int gn,
                                          T* __restrict__ outp) {
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) sum += to_float(vb[(int64_t)s * row_stride + d]);
    const T r = from_float<T>(sum / (float)S);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (g < gn) outp[g * HD + d] = r;
  }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                        const int* __restrict__ length, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int* __restrict__ arrivals,
                        T* __restrict__ out, int S, int K, int group, int n_sub, int n_splits,
                        int window, int ring, float scale) {
  using Sh = Shape<T, HD, G>;
  constexpr int R = Sh::R, EPL = Sh::EPL, VEC = Sh::VEC, CHUNKS = Sh::CHUNKS, RS = Sh::RS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [kWarps][kStages]
  int* last_flag = reinterpret_cast<int*>(smem + kWarps * kStages * sizeof(uint64_t));
  T* rings = reinterpret_cast<T*>(smem + kHeaderBytes);          // [kWarps][kStages][2][R][HD]
  float* scratch = reinterpret_cast<float*>(smem + kHeaderBytes);  // the rings, once drained

  const int split = blockIdx.x, k = blockIdx.y / n_sub, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's sub-group: query heads g0 .. g0 + gn - 1 of the KV head's group
  const int sub = blockIdx.y - k * n_sub, g0 = sub * G, gn = min(G, group - g0);

  int lo, hi;
  valid_range(length[b], S, window, ring, lo, hi);
  const int64_t len = hi - lo;
  const int64_t chunk = max64((len + n_splits - 1) / n_splits, kMinRows);
  const int64_t start = lo + min64((int64_t)split * chunk, len);
  const int64_t end = min64(hi, start + chunk);

  // this warp's share of [start, end): slot-sized groups warp, warp + kWarps, ...
  const int64_t groups = (end - start + R - 1) / R;
  const int mine = groups > warp ? (int)((groups - warp + kWarps - 1) / kWarps) : 0;
  uint64_t* bar = bars + warp * kStages;
  T* wring = rings + (int64_t)warp * kStages * 2 * R * HD;
  const int64_t row_stride = (int64_t)K * HD;
  const int64_t pair = (int64_t)b * K + k;      // (sequence, KV head)
  const int64_t unit = pair * n_sub + sub;      // (sequence, KV head, sub-group): partials, counter
  const T* __restrict__ kb = kc + ((int64_t)b * S * K + k) * HD;
  const T* __restrict__ vb = vc + ((int64_t)b * S * K + k) * HD;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) flrce::mbar_init(bar + s, 1);
    flrce::mbar_fence_init();
  }
  __syncwarp();

  // the warp's j-th group of rows into slot j % kStages: K rows, then V rows
  auto group_rows = [&](int j, int64_t& row0) {
    row0 = start + ((int64_t)warp + (int64_t)j * kWarps) * R;
    return (int)min64(R, end - row0);
  };
  auto issue = [&](int j) {
    int64_t row0;
    const int n = group_rows(j, row0);
    uint64_t* slot_bar = bar + j % kStages;
    if (lane == 0) flrce::mbar_arrive_expect_tx(slot_bar, (uint32_t)(2 * n * Sh::kRowBytes));
    __syncwarp();
    if (lane < n) {
      T* dst = wring + ((int64_t)(j % kStages) * 2 * R + lane) * HD;
      flrce::bulk_to_shared(dst, kb + (row0 + lane) * row_stride, Sh::kRowBytes, slot_bar);
      flrce::bulk_to_shared(dst + R * HD, vb + (row0 + lane) * row_stride, Sh::kRowBytes, slot_bar);
    }
  };
  for (int j = 0; j < kStages && j < mine; ++j) issue(j);

  // this block's query heads, scaled in fp32 as the reference does; a
  // dummy head past the group's end has q = 0
  float qr[G][EPL];
  const T* qp = q + (pair * group + g0) * HD;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < gn) {
      load_lane<T, VEC, CHUNKS>(qp + g * HD, lane, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] *= scale;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
  }

  for (int j = 0; j < mine; ++j) {
    int64_t row0;
    const int n = group_rows(j, row0);
    flrce::mbar_wait(bar + j % kStages, (uint32_t)((j / kStages) & 1));
    const T* ks = wring + (int64_t)(j % kStages) * 2 * R * HD;
    const T* vs = ks + R * HD;
#pragma unroll
    for (int r0 = 0; r0 < R; r0 += RS) {
      if (r0 < n) {  // row r0 is valid, so every m below is finite
        float x[RS][G];
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          float kr[EPL];
          load_lane<T, VEC, CHUNKS>(ks + (r0 + r) * HD, lane, kr);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float d = 0.0f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kr[e], d);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xFFFFFFFFu, d, o);
            x[r][g] = (r0 + r < n) ? d : -INFINITY;  // rows past `end` hold stale bytes
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float mx = x[0][g];
#pragma unroll
          for (int r = 1; r < RS; ++r) mx = fmaxf(mx, x[r][g]);
          const float m_new = fmaxf(m[g], mx);
          const float alpha = expf(m[g] - m_new);  // 0 on the first step (m = -inf)
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
          m[g] = m_new;
        }
#pragma unroll
        for (int r = 0; r < RS; ++r) {
          if (r0 + r < n) {
            float vr[EPL];
            load_lane<T, VEC, CHUNKS>(vs + (r0 + r) * HD, lane, vr);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float p = expf(x[r][g] - m[g]);
              l[g] += p;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
    if (j + kStages < mine) issue(j + kStages);
  }

  // combine the warps in shared memory, in warp order
  __syncthreads();  // every ring is drained: they become scratch
  float* sm_acc = scratch;                  // [kWarps][G][HD]
  float* sm_m = scratch + kWarps * G * HD;  // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;          // [kWarps][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(warp * G + g) * HD + c * 32 * VEC + lane * VEC + e] = acc[g][c * VEC + e];
  }
  __syncthreads();

  T* outp = out + (pair * group + g0) * HD;
  if (n_splits == 1 && len == 0) {
    mean_of_v<T, HD, G>(vb, S, row_stride, gn, outp);
    return;
  }
  const int64_t part = unit * n_splits + split;  // part_acc and part_ml are null with one split
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * G + g]);
    float a = 0.0f, lsum = 0.0f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w * G + g] - M);  // 0 for a warp that had no rows
        a = fmaf(sm_acc[w * G * HD + idx], c, a);
        lsum = fmaf(sm_l[w * G + g], c, lsum);
      }
    }
    if (n_splits == 1) {
      if (g < gn) outp[idx] = from_float<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      part_acc[part * G * HD + idx] = a;
      if (idx % HD == 0) {
        part_ml[(part * G + g) * 2] = M;
        part_ml[(part * G + g) * 2 + 1] = lsum;
      }
    }
  }
  if (n_splits == 1) return;

  // the last block of this (sequence, KV head, sub-group) to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last_flag = atomicAdd(arrivals + unit, 1) == n_splits - 1;
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  if (len == 0) {
    mean_of_v<T, HD, G>(vb, S, row_stride, gn, outp);
  } else {
    // Partials are read through L2 (__ldcg): other blocks wrote them.  The
    // first kChunk splits of this thread's accumulators are loaded together
    // with the (m, l) pairs, so a call with up to kChunk splits pays one L2
    // round trip for the whole combine.
    constexpr int kChunk = 16;
    float* sm_w = scratch;                  // [n][G]: m, then exp(m - M)
    float* sm_lp = scratch + n_splits * G;  // [n][G]: l
    float* sm_den = sm_lp + n_splits * G;   // [G]
    const float* ml = part_ml + unit * n_splits * G * 2;
    const float* pa = part_acc + unit * n_splits * G * HD;
    float4 a[kChunk];
    int i4 = threadIdx.x;  // this thread's first 4 outputs (of the block's gn real heads)
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (u < n_splits && i4 < gn * HD / 4)
        a[u] = __ldcg(reinterpret_cast<const float4*>(pa + (int64_t)u * G * HD) + i4);
    for (int i = threadIdx.x; i < n_splits * G; i += kThreads) {
      sm_w[i] = __ldcg(ml + 2 * i);
      sm_lp[i] = __ldcg(ml + 2 * i + 1);
    }
    __syncthreads();
    if (threadIdx.x < G) {
      const int g = threadIdx.x;
      float M = -INFINITY;
      for (int s = 0; s < n_splits; ++s) M = fmaxf(M, sm_w[s * G + g]);
      float den = 0.0f;
      for (int s = 0; s < n_splits; ++s) {
        const float c = expf(sm_w[s * G + g] - M);  // 0 for an empty split
        sm_w[s * G + g] = c;
        den = fmaf(sm_lp[s * G + g], c, den);
      }
      sm_den[g] = fmaxf(den, 1e-30f);
    }
    __syncthreads();
    for (; i4 < gn * HD / 4; i4 += kThreads) {
      const int idx = i4 * 4, g = idx / HD;
      float num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int s0 = 0; s0 < n_splits; s0 += kChunk) {
        if (s0 > 0 || i4 != (int)threadIdx.x) {
#pragma unroll
          for (int u = 0; u < kChunk; ++u)
            if (s0 + u < n_splits)
              a[u] = __ldcg(reinterpret_cast<const float4*>(pa + (int64_t)(s0 + u) * G * HD) + i4);
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (s0 + u < n_splits) {  // in split order
            const float c = sm_w[(s0 + u) * G + g];
            num[0] = fmaf(a[u].x, c, num[0]);
            num[1] = fmaf(a[u].y, c, num[1]);
            num[2] = fmaf(a[u].z, c, num[2]);
            num[3] = fmaf(a[u].w, c, num[3]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) outp[idx + e] = from_float<T>(num[e] / sm_den[g]);
    }
  }
  if (threadIdx.x == 0) arrivals[unit] = 0;  // zero at rest for the next call
}

// sets the instance's dynamic shared memory limit, once per device
template <typename T, int HD, int G>
cudaError_t prepare() {
  static unsigned long long configured = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((configured >> dev) & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_attention_kernel<T, HD, G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape<T, HD, G>::kSmemBytes);
  if (err == cudaSuccess && dev < 64) configured |= 1ull << dev;
  return err;
}

template <typename T>
struct TypeTag {
  using type = T;
};
template <int N>
using Int = std::integral_constant<int, N>;

// calls f(TypeTag<T>, Int<HD>, Int<G>) for the instance, or refuses it
template <typename T, int HD, typename F>
cudaError_t visit_g(int g, F& f) {
  switch (g) {
    case 1: return f(TypeTag<T>{}, Int<HD>{}, Int<1>{});
    case 2: return f(TypeTag<T>{}, Int<HD>{}, Int<2>{});
    case 3: return f(TypeTag<T>{}, Int<HD>{}, Int<3>{});
    case 4: return f(TypeTag<T>{}, Int<HD>{}, Int<4>{});
    case 5: return f(TypeTag<T>{}, Int<HD>{}, Int<5>{});
    case 6: return f(TypeTag<T>{}, Int<HD>{}, Int<6>{});
    case 7: return f(TypeTag<T>{}, Int<HD>{}, Int<7>{});
    case 8: return f(TypeTag<T>{}, Int<HD>{}, Int<8>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch's arguments, as flrce_decode_attention takes them.
struct FlrceDecodeArgs {
  const void* q;
  const void* kc;
  const void* vc;
  const int* length;
  float* part_acc;
  float* part_ml;
  int* arrivals;
  void* out;
  dim3 grid;
  int s, k, group, n_sub, ns, w, r;
  float scale;
  cudaStream_t stream;
};

// The build compiles this file once for each (dtype, head_dim) pair, with
// FLRCE_DECODE_PART = 3 * dtype + the index of head_dim among 64, 128, 256:
// that object holds the pair's instances (a block's G = 1..8) and the two
// host functions below that launch and size them, and part 0's object holds
// the entry points too, which pick the part.  Six compiles of 8 instances
// run side by side where one of 48 took most of the build.  The build reads
// the count of parts from the next line.
#define FLRCE_DECODE_PARTS 6
#ifndef FLRCE_DECODE_PART
#error "decode_attention.cu compiles one part at a time: define FLRCE_DECODE_PART"
#endif
#define FLRCE_DECODE_PART_FNS(P, T, HD)                                                           \
  cudaError_t flrce_decode_launch_##P(const FlrceDecodeArgs& a, int gs) {                          \
    auto launch = [&](auto t, auto hd, auto g) -> cudaError_t {                                    \
      using U = typename decltype(t)::type;                                                        \
      constexpr int kHd = decltype(hd)::value, kG = decltype(g)::value;                            \
      cudaError_t err = prepare<U, kHd, kG>();                                                     \
      if (err != cudaSuccess) return err;                                                          \
      decode_attention_kernel<U, kHd, kG>                                                          \
          <<<a.grid, kThreads, Shape<U, kHd, kG>::kSmemBytes, a.stream>>>(                         \
              static_cast<const U*>(a.q), static_cast<const U*>(a.kc),                             \
              static_cast<const U*>(a.vc), a.length, a.part_acc, a.part_ml, a.arrivals,            \
              static_cast<U*>(a.out), a.s, a.k, a.group, a.n_sub, a.ns, a.w, a.r, a.scale);        \
      return cudaGetLastError();                                                                   \
    };                                                                                             \
    return visit_g<T, HD>(gs, launch);                                                             \
  }                                                                                                \
  cudaError_t flrce_decode_occupancy_##P(int gs, int* blocks_per_sm, int* smem_bytes) {            \
    auto query = [&](auto t, auto hd, auto g) -> cudaError_t {                                     \
      using U = typename decltype(t)::type;                                                        \
      constexpr int kHd = decltype(hd)::value, kG = decltype(g)::value;                            \
      cudaError_t err = prepare<U, kHd, kG>();                                                     \
      if (err != cudaSuccess) return err;                                                          \
      *smem_bytes = Shape<U, kHd, kG>::kSmemBytes;                                                 \
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                        \
          blocks_per_sm, decode_attention_kernel<U, kHd, kG>, kThreads, *smem_bytes);              \
    };                                                                                             \
    return visit_g<T, HD>(gs, query);                                                              \
  }

#define FLRCE_DECODE_PART_DECL(P)                                          \
  cudaError_t flrce_decode_launch_##P(const FlrceDecodeArgs& a, int gs); \
  cudaError_t flrce_decode_occupancy_##P(int gs, int* blocks_per_sm, int* smem_bytes);

FLRCE_DECODE_PART_DECL(0)
FLRCE_DECODE_PART_DECL(1)
FLRCE_DECODE_PART_DECL(2)
FLRCE_DECODE_PART_DECL(3)
FLRCE_DECODE_PART_DECL(4)
FLRCE_DECODE_PART_DECL(5)

#if FLRCE_DECODE_PART == 0
FLRCE_DECODE_PART_FNS(0, float, 64)
#endif
#if FLRCE_DECODE_PART == 1
FLRCE_DECODE_PART_FNS(1, float, 128)
#endif
#if FLRCE_DECODE_PART == 2
FLRCE_DECODE_PART_FNS(2, float, 256)
#endif
#if FLRCE_DECODE_PART == 3
FLRCE_DECODE_PART_FNS(3, __nv_bfloat16, 64)
#endif
#if FLRCE_DECODE_PART == 4
FLRCE_DECODE_PART_FNS(4, __nv_bfloat16, 128)
#endif
#if FLRCE_DECODE_PART == 5
FLRCE_DECODE_PART_FNS(5, __nv_bfloat16, 256)
#endif

#if FLRCE_DECODE_PART == 0
namespace {

// the part of (dtype, HD), or -1: dtype 0 is fp32, 1 is bf16
int part_of(int dtype, int hd) {
  const int at = hd == 64 ? 0 : hd == 128 ? 1 : hd == 256 ? 2 : -1;
  return (dtype != 0 && dtype != 1) || at < 0 ? -1 : 3 * dtype + at;
}

cudaError_t (*const kLaunch[FLRCE_DECODE_PARTS])(const FlrceDecodeArgs&, int) = {
    flrce_decode_launch_0, flrce_decode_launch_1, flrce_decode_launch_2,
    flrce_decode_launch_3, flrce_decode_launch_4, flrce_decode_launch_5};
cudaError_t (*const kOccupancy[FLRCE_DECODE_PARTS])(int, int*, int*) = {
    flrce_decode_occupancy_0, flrce_decode_occupancy_1, flrce_decode_occupancy_2,
    flrce_decode_occupancy_3, flrce_decode_occupancy_4, flrce_decode_occupancy_5};

}  // namespace

extern "C" {

// out (B, K·G, HD) = decode attention of q (B, K·G, HD) over the caches
// (B, S, K, HD), all contiguous and 16-byte aligned, of one type: dtype 0 is
// fp32, 1 is bf16.  length is (B,) int32 on the card.  A block holds GS of
// the G heads of a KV head, so each KV head has n_sub = ceil(G / GS)
// sub-groups.  With n_splits > 1, part_acc holds B·K·n_sub·n_splits·GS·HD
// floats, part_ml B·K·n_sub·n_splits·GS·2 and arrivals B·K·n_sub int32
// zeros, which the launch leaves at zero; with one split all three may be
// null.  HD is 64, 128 or 256; 1 <= G <= 16; 1 <= GS <= 8; window >= 0;
// ring is 0 or 1; 1 <= n_splits <= 512.  One launch on `stream`.
int flrce_decode_attention(const void* q, const void* kc, const void* vc, const int* length,
                           float* part_acc, float* part_ml, int* arrivals, void* out, int64_t B,
                           int64_t S, int64_t K, int64_t G, int64_t GS, int64_t HD,
                           int64_t n_splits, int64_t window, int32_t ring, int32_t dtype,
                           float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || K < 1 || G < 1 || G > kMaxGroup || GS < 1 || GS > kMaxBlockGroup ||
      n_splits < 1 || n_splits > kMaxSplits || window < 0 || B > 65535 ||
      K * ((G + GS - 1) / GS) > 65535 || S > 0x7FFFFFFFLL || window > 0x7FFFFFFFLL ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int part = part_of((int)dtype, (int)HD);
  if (part < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_sub = (int)((G + GS - 1) / GS);
  const FlrceDecodeArgs a{q, kc, vc, length, part_acc, part_ml, arrivals, out,
                          dim3((unsigned)n_splits, (unsigned)(K * n_sub), (unsigned)B),
                          (int)S, (int)K, (int)G, n_sub, (int)n_splits, (int)window,
                          ring ? 1 : 0, scale, stream};
  return static_cast<int>(kLaunch[part](a, (int)GS));
}

// Blocks of the (dtype, HD, G) instance (G heads a block, 1..8) an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device, at
// the instance's dynamic shared memory, written to *smem_bytes).
int flrce_decode_attention_occupancy(int32_t dtype, int64_t HD, int64_t G, int* blocks_per_sm,
                                     int* smem_bytes) {
  const int part = part_of((int)dtype, (int)HD);
  if (part < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kOccupancy[part]((int)G, blocks_per_sm, smem_bytes));
}

}  // extern "C"
#endif
