// Cross-block machinery for kernels that spread one solve over many thread
// blocks of a cooperative launch: a barrier over a group of blocks and a sum
// of per-block partials taken in a fixed order.
//
// A kernel that runs several independent lanes side by side gives each lane
// its own group of blocks, and lanes finish after different numbers of
// iterations. A whole-grid barrier (cooperative_groups::this_grid().sync())
// would then wait for blocks that have already left, so the barrier here
// covers one group: one 64-bit arrival counter in global memory that only
// grows. Each block adds 1 with release semantics and waits, with acquire
// loads, until the counter reaches its own running target (the group's size
// times the barriers it has passed). Nothing resets it, so the barrier costs
// one atomic and the wait. It is an integer atomic; no float is ever summed
// with an atomic here.
//
// Data that other blocks wrote during the launch is read with __ldcg (L2,
// never a stale L1 line).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_gather.cuh"

// about 20 s at the H100's 1.98 GHz boost clock
constexpr long long kBarrierTimeoutCycles = 40000000000LL;

__device__ __forceinline__ unsigned long long ld_acquire_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// One group's barrier: `count` is the group's counter (0 before the
// launch), `nblocks` its size; `target` is kept by thread 0 of each block.
struct GroupBarrier {
  unsigned long long* count;
  unsigned long long target;
  unsigned int nblocks;
};

// Every global write a block of the group made before the barrier is
// visible to every block of the group after it. `synced`: the caller's
// threads have just passed a __syncthreads after their last global write,
// so the leading one is skipped. A group of one block needs no more than
// one __syncthreads.
__device__ __forceinline__ void group_sync(GroupBarrier& g, bool synced = false) {
  if (g.nblocks == 1) {
    __syncthreads();
    return;
  }
  if (!synced) __syncthreads();
  if (threadIdx.x == 0) {
    g.target += g.nblocks;
    // bar.sync above orders the block's writes before this release
    red_release_gpu(g.count, 1ull);
    // a block of the group that never arrives (a launch that is not all
    // resident, a block that left the loop alone) is a fault: stop the
    // kernel with an error after kBarrierTimeoutCycles instead of hanging
    const long long t0 = clock64();
    while (ld_acquire_gpu(g.count) < g.target) {
      if (clock64() - t0 > kBarrierTimeoutCycles) __trap();
    }
  }
  __syncthreads();
}

// Copy n floats that another block may have written into shared memory
// (16-byte vectors when both ends are aligned), with `count` threads
// starting at thread `first`.
__device__ __forceinline__ void stage_floats(float* dst, const float* src, int n, int first,
                                             int count) {
  const int i0 = (int)threadIdx.x - first;
  if (i0 < 0 || i0 >= count) return;
  if ((n & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int i = i0; i < (n >> 2); i += count) d4[i] = __ldcg(s4 + i);
  } else {
#pragma unroll 4
    for (int i = i0; i < n; i += count) dst[i] = __ldcg(src + i);
  }
}

// Sum each of the first `rows` (all N by default) partial rows
// part[i * nb + j] over the group's nb blocks, j in order: lane l of warp 0
// adds j = l, l + 32, ... in turn, then the xor butterfly adds the 32 lane
// sums. Every block of the group runs the same sums on the same bits, so
// every block ends with bitwise the same totals (returned in v to every
// thread; v[rows..N) stay as they were). Meanwhile the block's other
// threads stage n floats src -> dst (n = 0: nothing), so the two L2 reads
// overlap. red is shared scratch of N floats; the caller syncs before it
// is written again.
template <int N, int kThreadsPerBlock>
__device__ __forceinline__ void group_sum(const float* part, int nb, float (&v)[N], float* red,
                                          float* dst = nullptr, const float* src = nullptr,
                                          int n = 0, int rows = N) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < rows) {
        float s = 0.f;
#pragma unroll 4
        for (int j = lane; j < nb; j += 32) s += __ldcg(part + i * nb + j);
        s = warp_sum(s);
        if (lane == 0) red[i] = s;
      }
    }
  } else if (n > 0) {
    stage_floats(dst, src, n, 32, kThreadsPerBlock - 32);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < rows) v[i] = red[i];
  }
}
