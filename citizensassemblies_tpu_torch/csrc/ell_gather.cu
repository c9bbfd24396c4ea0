// ELL gather matvec for Hopper (sm_90a): z[b, c] = sum_s val[b, c, s] * y[b, idx[c, s]].
//
// Replaces: citizensassemblies_tpu/kernels/ell_matvec.py:_ell_gather_kernel
// (one Pallas program per column block, the gather source y resident in
// VMEM, output lane-padded to [C_pad, 128] with column 0 used).
//
// What bounds it on the H100: bytes. Each packed slot is read once (4 B index
// + 4 B value) and used for one multiply-add, so the kernel moves C*kp*8
// bytes for C*kp*2 flops, far below the card's ridge point. The source y is
// only T floats and is reused by every column.
//
// Design: each thread block stages y for its lane in shared memory (T floats,
// the counterpart of the resident VMEM row), then one warp computes one
// packed column at a time: its 32 lanes read consecutive slots of the
// row-major pack (coalesced 128-byte reads), gather y from shared memory and
// sum with a warp shuffle. Several columns per warp amortise the staging of
// y. The lane axis b is the grid's y dimension: idx is shared by all lanes,
// val is shared (val_bstride = 0) or per lane. The output is [B, C] with no
// lane padding. Deterministic: the summation order is fixed.

#include "ell_gather.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kColsPerWarp = 4;

__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                  long long val_bstride, const float* __restrict__ y,
                  float* __restrict__ out, int T, int C, int kp) {
  extern __shared__ float ys[];
  const int b = blockIdx.y;
  const float* yb = y + (long long)b * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) ys[t] = yb[t];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c0 = (blockIdx.x * nwarps + warp) * kColsPerWarp;
  const float* vb = val + (long long)b * val_bstride;
  for (int j = 0; j < kColsPerWarp; ++j) {
    const int c = c0 + j;
    if (c >= C) break;
    const long long row = (long long)c * kp;
    float z = warp_sum(ell_dot(idx + row, vb + row, lane, 32, kp, 1, ys));
    if (lane == 0) out[(long long)b * C + c] = z;
  }
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int ell_gather_launch(const void* idx, const void* val,
                                 long long val_bstride, const void* y,
                                 void* out, int B, int T, int C, int kp,
                                 void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const size_t smem = (size_t)T * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ell_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols_per_block = (kThreads / 32) * kColsPerWarp;
  dim3 grid((C + cols_per_block - 1) / cols_per_block, B);
  ell_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)val, val_bstride, (const float*)y,
      (float*)out, T, C, kp);
  return (int)cudaGetLastError();
}
