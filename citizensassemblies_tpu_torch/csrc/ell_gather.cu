// ELL gather matvec for Hopper (sm_90a): z[b, c] = sum_s val[b, c, s] * y[b, idx[c, s]].
//
// Replaces: citizensassemblies_tpu/kernels/ell_matvec.py:_ell_gather_kernel
// (one Pallas program per column block, the gather source y resident in
// VMEM, output lane-padded to [C_pad, 128] with column 0 used).
//
// What bounds it on the H100: bytes. Each packed slot is read once (4 B index
// + 4 B value) and used for one multiply-add, so the kernel moves C*kp*8
// bytes for C*kp*2 flops, far below the card's ridge point. The source y is
// only T floats and is reused by every column. At the path's shapes (C =
// 6144 or 4096, kp = 112) that is 3.7-5.5 MB, about a microsecond and a half
// at HBM rate, so the kernel is short and what counts is how soon every SM
// has its share of the loads in flight.
//
// Design: each thread block stages y for its lane in shared memory (T floats,
// the counterpart of the resident VMEM row). A column is read by a group of
// G consecutive lanes (G = 4 at kp = 112: the largest of 8, 4, 2, 1 that
// divides kp / 4), each lane loading 16-byte vectors of 4 indices and 4
// values (lane g of the group takes vectors g, g + G, ...), gathering y
// from shared memory and summing in order; the group's lanes are then added
// by the xor butterfly. No lane idles for part of a pass, and consecutive
// lanes read consecutive 16 bytes. Blocks have up to four warps, fewer when
// that is what it takes for the grid to cover every SM (at C = 4096, B = 1:
// three warps, 171 blocks); the wrapper picks G and the block size. The lane axis b is the grid's y dimension: idx is
// shared by all lanes, val is shared (val_bstride = 0) or per lane. The
// output is [B, C] with no lane padding. Deterministic: the summation order
// is fixed. Padding slots (value 0, index 0) add 0 * y[0], as in the
// reference, so a NaN in y[0] reaches every padded column.
//
// bf16 values (ell_gather_bf16_launch): the pack of a demoted operand
// (utils/precision.py) holds its values as bf16, 2 bytes a slot against the
// index's 4, so the kernel moves C*kp*6 bytes instead of C*kp*8. Packs have
// kp % 8 == 0, so a bf16 row starts on a 16-byte boundary: a lane reads 8
// values in one 16-byte load beside two int4 index loads, and each value is
// widened exactly to float32 (a bf16 is the upper half of a float32) before
// its multiply-add. The output must be bitwise the float32 path's on the
// same (lossless) values, so the sum keeps that path's order: with G lanes
// per column there, this path runs G/2, and its lane h holds two float32
// sums, those of the float32 path's lanes 2h and 2h + 1 (16-byte vectors
// 2u and 2u + 1 of its 8-value vector u, u = h, h + G/2, ...). The xor
// butterfly over the G/2 lanes on each sum, then their one add, is the
// float32 path's butterfly over G lanes step for step.

#include <stdint.h>

#include "ell_gather.cuh"

namespace {

constexpr int kMaxWarps = 4;

template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
ell_gather_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                  long long val_bstride, const float* __restrict__ y,
                  float* __restrict__ out, int T, int C, int kp) {
  extern __shared__ __align__(16) float ys[];
  const int b = blockIdx.y;
  const float* yb = y + (long long)b * T;
  // y as 16-byte vectors where its row starts on a 16-byte boundary (the
  // small blocks would otherwise wait out many serial loads each)
  int t0 = 0;
  if ((reinterpret_cast<uintptr_t>(yb) & 15) == 0) {
    t0 = T & ~3;
    const float4* y4 = reinterpret_cast<const float4*>(yb);
    float4* s4 = reinterpret_cast<float4*>(ys);
#pragma unroll 4
    for (int t = threadIdx.x; t < (T >> 2); t += blockDim.x) s4[t] = __ldg(y4 + t);
  }
  for (int t = t0 + threadIdx.x; t < T; t += blockDim.x) ys[t] = __ldg(yb + t);
  __syncthreads();
  const int g = threadIdx.x % G;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  float acc = 0.f;
  if (c < C) {
    const long long row = (long long)c * kp;
    const int4* i4 = reinterpret_cast<const int4*>(idx + row);
    const float4* v4 = reinterpret_cast<const float4*>(val + (long long)b * val_bstride + row);
    const int kv = kp >> 2;
#pragma unroll 4
    for (int v = g; v < kv; v += G) {
      const int4 ii = __ldg(i4 + v);
      const float4 vv = __ldg(v4 + v);
      acc += vv.x * ys[ii.x];
      acc += vv.y * ys[ii.y];
      acc += vv.z * ys[ii.z];
      acc += vv.w * ys[ii.w];
    }
  }
  // every lane of the warp takes part (a column past C adds 0)
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (g == 0 && c < C) out[(long long)b * C + c] = acc;
}

template <int G>
cudaError_t launch(const int* idx, const float* val, long long val_bstride, const float* y,
                   float* out, int B, int T, int C, int kp, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)T * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ell_gather_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long lanes = (long long)C * G;
  dim3 grid((unsigned)((lanes + threads - 1) / threads), B);
  ell_gather_kernel<G><<<grid, threads, smem, stream>>>(idx, val, val_bstride, y, out, T, C, kp);
  return cudaGetLastError();
}

// a bf16 value, the low or high half of a 32-bit word, widened to float32
__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }

template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32)
ell_gather_bf16_kernel(const int* __restrict__ idx, const unsigned short* __restrict__ val,
                       long long val_bstride, const float* __restrict__ y,
                       float* __restrict__ out, int T, int C, int kp) {
  extern __shared__ __align__(16) float ys[];
  const int b = blockIdx.y;
  const float* yb = y + (long long)b * T;
  int t0 = 0;
  if ((reinterpret_cast<uintptr_t>(yb) & 15) == 0) {
    t0 = T & ~3;
    const float4* y4 = reinterpret_cast<const float4*>(yb);
    float4* s4 = reinterpret_cast<float4*>(ys);
#pragma unroll 4
    for (int t = threadIdx.x; t < (T >> 2); t += blockDim.x) s4[t] = __ldg(y4 + t);
  }
  for (int t = t0 + threadIdx.x; t < T; t += blockDim.x) ys[t] = __ldg(yb + t);
  __syncthreads();
  const int g = threadIdx.x % G;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  // the float32 path's lanes 2g (acc0) and 2g + 1 (acc1)
  float acc0 = 0.f, acc1 = 0.f;
  if (c < C) {
    const long long row = (long long)c * kp;
    const int4* i4 = reinterpret_cast<const int4*>(idx + row);
    const uint4* v8 = reinterpret_cast<const uint4*>(val + (long long)b * val_bstride + row);
    const int ku = kp >> 3;
#pragma unroll 2
    for (int u = g; u < ku; u += G) {
      const int4 ia = __ldg(i4 + 2 * u);
      const int4 ib = __ldg(i4 + 2 * u + 1);
      const uint4 vv = __ldg(v8 + u);
      acc0 += bf16_lo(vv.x) * ys[ia.x];
      acc0 += bf16_hi(vv.x) * ys[ia.y];
      acc0 += bf16_lo(vv.y) * ys[ia.z];
      acc0 += bf16_hi(vv.y) * ys[ia.w];
      acc1 += bf16_lo(vv.z) * ys[ib.x];
      acc1 += bf16_hi(vv.z) * ys[ib.y];
      acc1 += bf16_lo(vv.w) * ys[ib.z];
      acc1 += bf16_hi(vv.w) * ys[ib.w];
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    acc0 += __shfl_xor_sync(0xffffffffu, acc0, o);
    acc1 += __shfl_xor_sync(0xffffffffu, acc1, o);
  }
  if (g == 0 && c < C) out[(long long)b * C + c] = acc0 + acc1;
}

template <int G>
cudaError_t launch_bf16(const int* idx, const unsigned short* val, long long val_bstride,
                        const float* y, float* out, int B, int T, int C, int kp, int threads,
                        cudaStream_t stream) {
  const size_t smem = (size_t)T * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ell_gather_bf16_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long lanes = (long long)C * G;
  dim3 grid((unsigned)((lanes + threads - 1) / threads), B);
  ell_gather_bf16_kernel<G><<<grid, threads, smem, stream>>>(idx, val, val_bstride, y, out, T,
                                                             C, kp);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. idx and val start on 16-byte boundaries, kp is a multiple
// of 4, G (lanes per column: 1, 2, 4 or 8) divides kp / 4 and threads (per
// block) is a multiple of 32 up to 32 * kMaxWarps; the wrapper
// (kernels/ell_matvec.launch_shape) picks both. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ell_gather_launch(const void* idx, const void* val,
                                 long long val_bstride, const void* y,
                                 void* out, int B, int T, int C, int kp, int G,
                                 int threads, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (kp <= 0 || (kp & 3) != 0 || (val_bstride & 3) != 0 ||
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) != 0 ||
      threads <= 0 || threads > 32 * kMaxWarps || (threads & 31) != 0 || (kp >> 2) % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* i = (const int*)idx;
  const float* v = (const float*)val;
  const float* yy = (const float*)y;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 8: return (int)launch<8>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    case 4: return (int)launch<4>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    case 2: return (int)launch<2>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    case 1: return (int)launch<1>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16-value entry point: val holds bf16 values (raw 16-bit words),
// kp is a multiple of 8, val_bstride a multiple of 8, idx and val start on
// 16-byte boundaries, and G (lanes per column: 1, 2 or 4, half the float32
// path's) divides kp / 8; the wrapper (kernels/ell_matvec.launch_shape
// with bf16=True) picks G and threads. Returns the launch's cudaError_t.
extern "C" int ell_gather_bf16_launch(const void* idx, const void* val,
                                      long long val_bstride, const void* y,
                                      void* out, int B, int T, int C, int kp, int G,
                                      int threads, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (kp <= 0 || (kp & 7) != 0 || (val_bstride & 7) != 0 ||
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) != 0 ||
      threads <= 0 || threads > 32 * kMaxWarps || (threads & 31) != 0 || G <= 0 ||
      (kp >> 3) % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* i = (const int*)idx;
  const unsigned short* v = (const unsigned short*)val;
  const float* yy = (const float*)y;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 4: return (int)launch_bf16<4>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    case 2: return (int)launch_bf16<2>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    case 1: return (int)launch_bf16<1>(i, v, val_bstride, yy, o, B, T, C, kp, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
