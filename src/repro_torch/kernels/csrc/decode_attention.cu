// One-query GQA attention over a KV cache (flash-decoding), bf16 or fp32.
//
// Replaces the reference's Pallas kernel src/repro/kernels/decode_attention.py:86
// decode_attention (_decode_attn_kernel), and covers the window / ring masks of
// decode_attention_jnp (src/repro/models/attention.py:176), the function the
// reference's serving path calls.  For q (B, H, hd), caches (B, S, K, hd) and
// length (B,), with G = H / K query heads per KV head:
//   * valid slots: ring: s < min(length, S); otherwise s < length, and with
//     window > 0 also s >= length - window.  Either way a contiguous range
//     [lo, hi) of slots;
//   * logits = (q·(1/sqrt(hd)) in fp32) · K in fp32, softmax over the valid
//     slots, out = Σ p·V in fp32, written in q's dtype;
//   * an empty range (length 0): the reference masks every logit to -1e30,
//     so its softmax is uniform over all S slots and the output is the mean of
//     V over the whole cache.  The combine pass computes exactly that.
//
// What bounds it here: each K/V row is read once and used for 2·G flops per
// element, about 2 flops per byte at G = 2 in bf16, so device memory
// bandwidth: the least time is the valid K/V bytes over the card's bandwidth.
// What the design does about it:
//   * split-S: one block per (split of the valid range, KV head, sequence),
//     so B·K·n_splits blocks fill the card whatever the batch; the splits lie
//     over [lo, hi) only, so no byte past the valid range is read;
//   * the G query heads of a KV head share the block, so each K/V row is read
//     once for all of them;
//   * a warp takes R consecutive cache rows at a time: lane i holds elements
//     [i·hd/32, (i+1)·hd/32) of each row (16 bytes at hd 256 in bf16), so a
//     row is one coalesced transaction and R rows of K and V are in flight
//     per warp before any arithmetic waits on them;
//   * each warp keeps its own running (m, l, acc[G][hd/32]) with one rescale
//     per R rows; warps combine in shared memory and each block writes its
//     (m, l, acc) to a scratch buffer; a second small pass combines the
//     splits in a fixed order and divides by max(l, 1e-30), as the Pallas
//     kernel does.  No atomics: the result is bitwise repeatable.
// Masked logits contribute exactly 0 in the reference (exp(-1e30 - m)
// underflows), so skipping those slots changes nothing.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinRows = 32;  // fewest rows a split takes before fewer splits run
constexpr int kCombineThreads = 256;

// rows a warp has in flight: fewer where G · hd/32 registers already crowd the warp
template <int G, int EPL>
struct RowsPerStep {
  static constexpr int value = (G * EPL <= 16) ? 4 : (G * EPL <= 32 ? 2 : 1);
};

__device__ __forceinline__ void bf16x2(uint32_t u, float& a, float& b) {
  a = __uint_as_float(u << 16);           // the first element is the low half
  b = __uint_as_float(u & 0xFFFF0000u);
}

// EPL consecutive elements at p (aligned to EPL elements) as floats
template <typename T, int EPL>
struct Row;

template <int EPL>
struct Row<float, EPL> {
  static_assert(EPL % 2 == 0, "EPL is 2, 4 or 8");
  __device__ __forceinline__ static void load(const float* __restrict__ p, float (&x)[EPL]) {
    if constexpr (EPL == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      x[0] = t.x;
      x[1] = t.y;
    } else {
#pragma unroll
      for (int i = 0; i < EPL; i += 4) {
        float t[4];
        flrce::load_vec<4>(p + i, t);
        x[i] = t[0];
        x[i + 1] = t[1];
        x[i + 2] = t[2];
        x[i + 3] = t[3];
      }
    }
  }
  __device__ __forceinline__ static float one(const float* __restrict__ p) { return __ldg(p); }
  __device__ __forceinline__ static float to_out(float v) { return v; }
};

template <int EPL>
struct Row<__nv_bfloat16, EPL> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* __restrict__ p, float (&x)[EPL]) {
    if constexpr (EPL == 2) {
      const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
      bf16x2(u, x[0], x[1]);
    } else if constexpr (EPL == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      bf16x2(u.x, x[0], x[1]);
      bf16x2(u.y, x[2], x[3]);
    } else {
      static_assert(EPL == 8, "EPL is 2, 4 or 8");
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      bf16x2(u.x, x[0], x[1]);
      bf16x2(u.y, x[2], x[3]);
      bf16x2(u.z, x[4], x[5]);
      bf16x2(u.w, x[6], x[7]);
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* __restrict__ p) {
    return __bfloat162float(p[0]);
  }
  __device__ __forceinline__ static __nv_bfloat16 to_out(float v) { return __float2bfloat16_rn(v); }
};

// the valid slot range [lo, hi) of one sequence
__device__ __forceinline__ void valid_range(int len, int S, int window, int ring, int& lo, int& hi) {
  hi = min(len, S);
  lo = (!ring && window > 0) ? max(0, len - window) : 0;
  if (hi < lo) hi = lo;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ length, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int S, int K, int n_splits, int window, int ring,
                    float scale) {
  constexpr int EPL = HD / 32;
  constexpr int R = RowsPerStep<G, EPL>::value;
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][HD];

  const int split = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int lo, hi;
  valid_range(length[b], S, window, ring, lo, hi);
  int chunk = (hi - lo + n_splits - 1) / n_splits;
  chunk = max(chunk, kMinRows);
  const int start = lo + min(split * chunk, hi - lo);
  const int end = min(hi, start + chunk);

  // this block's G query heads, scaled in fp32 as the reference does
  float qr[G][EPL];
  const T* qp = q + ((int64_t)b * K * G + (int64_t)k * G) * HD + lane * EPL;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Row<T, EPL>::load(qp + (int64_t)g * HD, qr[g]);
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

  const int64_t row_stride = (int64_t)K * HD;
  const int64_t off = (int64_t)b * S * row_stride + (int64_t)k * HD + lane * EPL;
  const T* __restrict__ kb = kc + off;
  const T* __restrict__ vb = vc + off;

  for (int base = start + warp * R; base < end; base += kWarps * R) {
    float kr[R][EPL], vr[R][EPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (base + r < end) {
        Row<T, EPL>::load(kb + (int64_t)(base + r) * row_stride, kr[r]);
        Row<T, EPL>::load(vb + (int64_t)(base + r) * row_stride, vr[r]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[r][e] = vr[r][e] = 0.0f;
      }
    }
    float x[R][G];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kr[r][e], d);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xFFFFFFFFu, d, o);
        x[r][g] = (base + r < end) ? d : -INFINITY;
      }
    }
    // row `base` is valid, so every m_new below is finite
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = x[0][g];
#pragma unroll
      for (int r = 1; r < R; ++r) mx = fmaxf(mx, x[r][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);  // 0 on the first step (m = -inf)
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = expf(x[r][g] - m_new);  // 0 for rows past `end`
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[r][e], acc[g][e]);
      }
      m[g] = m_new;
    }
  }

  // combine the warps in shared memory, in warp order
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  const int64_t part = ((int64_t)b * K + k) * n_splits + split;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float a = 0.0f, lsum = 0.0f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(sm_m[w][g] - M);  // 0 for a warp that had no rows
        a = fmaf(sm_acc[w][g][d], c, a);
        lsum = fmaf(sm_l[w][g], c, lsum);
      }
    }
    part_acc[part * G * HD + idx] = a;
    if (d == 0) {
      part_ml[(part * G + g) * 2] = M;
      part_ml[(part * G + g) * 2 + 1] = lsum;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                      const T* __restrict__ vc, const int* __restrict__ length,
                      T* __restrict__ out, int S, int K, int G, int HD, int n_splits, int window,
                      int ring) {
  const int k = blockIdx.x, b = blockIdx.y;
  int lo, hi;
  valid_range(length[b], S, window, ring, lo, hi);
  const int64_t part0 = ((int64_t)b * K + k) * n_splits;
  for (int idx = threadIdx.x; idx < G * HD; idx += kCombineThreads) {
    const int g = idx / HD, d = idx % HD;
    float res;
    if (hi == lo) {
      // every logit masked: the reference's softmax is uniform over all S slots
      const T* vp = vc + (int64_t)b * S * K * HD + (int64_t)k * HD + d;
      float sum = 0.0f;
      for (int s = 0; s < S; ++s) sum += Row<T, 2>::one(vp + (int64_t)s * K * HD);
      res = sum / (float)S;
    } else {
      float M = -INFINITY;
      for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part_ml[((part0 + s) * G + g) * 2]);
      float num = 0.0f, den = 0.0f;
      for (int s = 0; s < n_splits; ++s) {
        const float c = expf(part_ml[((part0 + s) * G + g) * 2] - M);  // 0 for an empty split
        num = fmaf(part_acc[(part0 + s) * G * HD + idx], c, num);
        den = fmaf(part_ml[((part0 + s) * G + g) * 2 + 1], c, den);
      }
      res = num / fmaxf(den, 1e-30f);
    }
    out[(((int64_t)b * K + k) * G + g) * HD + d] = Row<T, 2>::to_out(res);
  }
}

template <typename T, int HD, int G>
cudaError_t launch_split(const void* q, const void* kc, const void* vc, const int* length,
                         float* part_acc, float* part_ml, int B, int S, int K, int n_splits,
                         int window, int ring, float scale, cudaStream_t stream) {
  const dim3 grid(n_splits, K, B);
  decode_split_kernel<T, HD, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc), length,
      part_acc, part_ml, S, K, n_splits, window, ring, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_split_g(int G, const void* q, const void* kc, const void* vc, const int* length,
                           float* part_acc, float* part_ml, int B, int S, int K, int n_splits,
                           int window, int ring, float scale, cudaStream_t stream) {
#define FLRCE_G(N)                                                                          \
  case N:                                                                                   \
    return launch_split<T, HD, N>(q, kc, vc, length, part_acc, part_ml, B, S, K, n_splits, \
                                  window, ring, scale, stream);
  switch (G) {
    FLRCE_G(1)
    FLRCE_G(2)
    FLRCE_G(3)
    FLRCE_G(4)
    FLRCE_G(5)
    FLRCE_G(6)
    FLRCE_G(7)
    FLRCE_G(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLRCE_G
}

template <typename T>
cudaError_t launch_all(int G, int HD, const void* q, const void* kc, const void* vc,
                       const int* length, float* part_acc, float* part_ml, void* out, int B,
                       int S, int K, int n_splits, int window, int ring, float scale,
                       cudaStream_t stream) {
  cudaError_t err;
  switch (HD) {
    case 64:
      err = launch_split_g<T, 64>(G, q, kc, vc, length, part_acc, part_ml, B, S, K, n_splits,
                                  window, ring, scale, stream);
      break;
    case 128:
      err = launch_split_g<T, 128>(G, q, kc, vc, length, part_acc, part_ml, B, S, K, n_splits,
                                   window, ring, scale, stream);
      break;
    case 256:
      err = launch_split_g<T, 256>(G, q, kc, vc, length, part_acc, part_ml, B, S, K, n_splits,
                                   window, ring, scale, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(K, B), kCombineThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const T*>(vc), length, static_cast<T*>(out), S, K, G, HD,
      n_splits, window, ring);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, K·G, HD) = decode attention of q (B, K·G, HD) over the caches
// (B, S, K, HD), all contiguous and 16-byte aligned, of one type: dtype 0 is
// fp32, 1 is bf16.  length is (B,) int32 on the card.  part_acc holds
// B·K·n_splits·G·HD floats and part_ml B·K·n_splits·G·2.  HD is 64, 128 or
// 256; 1 <= G <= 8; window >= 0; ring is 0 or 1.
int flrce_decode_attention(const void* q, const void* kc, const void* vc, const int* length,
                           float* part_acc, float* part_ml, void* out, int64_t B, int64_t S,
                           int64_t K, int64_t G, int64_t HD, int64_t n_splits, int64_t window,
                           int32_t ring, int32_t dtype, float scale, cudaStream_t stream) {
  if (B < 1 || S < 1 || K < 1 || G < 1 || G > 8 || n_splits < 1 || window < 0 ||
      B > 65535 || K > 65535 || n_splits > 0x7FFFFFFFLL || S > 0x7FFFFFFFLL || window > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int b = (int)B, s = (int)S, k = (int)K, g = (int)G, hd = (int)HD, ns = (int)n_splits;
  const int w = (int)window, r = ring ? 1 : 0;
  cudaError_t err;
  if (dtype == 0) {
    err = launch_all<float>(g, hd, q, kc, vc, length, part_acc, part_ml, out, b, s, k, ns, w, r,
                            scale, stream);
  } else if (dtype == 1) {
    err = launch_all<__nv_bfloat16>(g, hd, q, kc, vc, length, part_acc, part_ml, out, b, s, k,
                                    ns, w, r, scale, stream);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
