// Device helpers shared by the ELL gather kernel (ell_gather.cu) and the two
// PDHG block kernels (two_sided_block.cu, lp_block.cu).
//
// The packed gather z[c] = sum_s val[c,s] * y[idx[c,s]] is the one matvec
// the kernels share: the two block kernels run it one group of lanes per
// packed column or row over the row-major pack (ell_dot, the inner product
// over a start slot, a step and a slot stride); the gather kernel has its
// own inner loop of 16-byte vectors. Padding slots carry value 0 and index 0,
// so they add 0 * y[0]: a NaN in y[0] reaches every padded column, exactly
// as in the reference.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same value, since each step
  // adds the same two operands on both partner lanes
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over slots s = begin, begin + step, ... < kp of val[s*stride] * y[idx[s*stride]]
__device__ __forceinline__ float ell_dot(const int* __restrict__ idx,
                                         const float* __restrict__ val,
                                         int begin, int step, int kp,
                                         long long stride,
                                         const float* __restrict__ y) {
  float acc = 0.f;
#pragma unroll 4
  for (int s = begin; s < kp; s += step) {
    const long long o = (long long)s * stride;
    acc += val[o] * y[idx[o]];
  }
  return acc;
}

// NaN-propagating max(x, 0) / min(x, 0) / min(a, b) / clip, matching
// jnp.maximum / jnp.minimum / jnp.clip (fmaxf and fminf drop a NaN operand)
__device__ __forceinline__ float max0(float x) { return x < 0.f ? 0.f : x; }
__device__ __forceinline__ float min0(float x) { return x > 0.f ? 0.f : x; }
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Sum each of v[0..N) over the thread block; every thread ends with the
// totals. red is shared scratch of at least N * 33 floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = warp_sum(v[i]);
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = lane < nw ? red[i * 32 + lane] : 0.f;
      s = warp_sum(s);
      if (lane == 0) red[N * 32 + i] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = red[N * 32 + i];
}
