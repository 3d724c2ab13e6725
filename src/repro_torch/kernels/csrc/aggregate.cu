// Eq. 4 aggregation, out = w + Σ_k p_k·u_k, fp32, in one streaming pass.
//
// Replaces the reference's Pallas kernel src/repro/kernels/aggregate.py:
// weighted_aggregate (_aggregate_kernel), which streams (P, 4096) tiles of U
// with the matching slice of w through VMEM and reduces the P axis on the
// MXU.
//
// What bounds it here: it does 2·P FLOP for every (P+2)·4 B it moves (read
// each of the P update rows and w once, write out once): 28.6 MB at the main
// path's P = 10, D = 595,914, so memory bandwidth is the only limit.  The
// design moves exactly those bytes once: a grid-stride loop over D where
// each thread owns VEC consecutive columns (16-byte or 8-byte loads when the
// rows are aligned, scalar otherwise), sums the P weighted terms in a fixed
// order with fp32 FMA, then adds w — the grouping of the reference's
// `w + p @ U` — and writes the result once.  No shared memory, no atomics.
#include "common.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(256)
aggregate_kernel(const float* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ p, float* __restrict__ out, int64_t P, int64_t D) {
  const int64_t n_vec = D / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
       i += stride) {
    const int64_t d = i * VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int64_t k = 0; k < P; ++k) {
      const float pk = __ldg(p + k);
      float uu[VEC];
      flrce::load_vec<VEC>(u + k * D + d, uu);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(pk, uu[e], acc[e]);
    }
    float ww[VEC];
    flrce::load_vec<VEC>(w + d, ww);
    float res[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) res[e] = ww[e] + acc[e];
    flrce::store_vec<VEC>(out + d, res);
  }
}

}  // namespace

extern "C" {

// out (D,) = w (D,) + p (P,) · u (P, D); vec in {1, 2, 4} must divide D.
int flrce_weighted_aggregate(const float* w, const float* u, const float* p, float* out,
                             int64_t P, int64_t D, int64_t blocks, int vec,
                             cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(256);
  switch (vec) {
    case 4:
      aggregate_kernel<4><<<grid, block, 0, stream>>>(w, u, p, out, P, D);
      break;
    case 2:
      aggregate_kernel<2><<<grid, block, 0, stream>>>(w, u, p, out, P, D);
      break;
    case 1:
      aggregate_kernel<1><<<grid, block, 0, stream>>>(w, u, p, out, P, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
