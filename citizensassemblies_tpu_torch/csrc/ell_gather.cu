// ELL gather matvec for Hopper (sm_90a): z[b, c] = sum_s val[b, c, s] * y[b, idx[c, s]].
//
// Replaces: citizensassemblies_tpu/kernels/ell_matvec.py:_ell_gather_kernel
// (one Pallas program per column block, the gather source y resident in
// VMEM, output lane-padded to [C_pad, 128] with column 0 used).
//
// What bounds it on the H100: bytes. Each packed slot is read once (4 B index
// + 4 B value, or 2 B for a bf16 value) and used for one multiply-add, so the
// kernel moves C*kp*8 bytes (C*kp*6 with bf16 values) for C*kp*2 flops, far
// below the card's ridge point. The source y is only T floats and is reused by
// every column. At the path's shapes (C = 6144 or 4096, kp = 112) that is
// 3.7-5.5 MB, a microsecond and a half at HBM rate, so the kernel is short:
// what counts is how soon every SM has its share of the pack in flight, and
// that no SM carries more than its share.
//
// Design (the plan is kernels/ell_matvec.launch_plan): a balanced grid. Every
// lane (gridDim.y) has the same blocks of contiguous columns, ranges differing
// by at most one column, a whole number of blocks for every SM. A warp owns
// 32 / G consecutive columns of its block's range, so its share of the pack
// is one contiguous span of indices and one of values. The block's last
// tma_warps warps pull their spans into shared memory with 1-D TMA bulk
// copies (cp.async.bulk ... mbarrier::complete_tx::bytes): at entry, lane 0
// of each such warp initialises the warp's mbarrier and issues its two
// copies, one stage of a ring of tma_warps stages, so every stage is in
// flight at once and each is summed as soon as it lands. The other warps
// load the first kPrefetchBytes of each lane's row into registers. Only
// then does the block store y (whose first words every thread loaded first,
// into registers) into shared memory and wait on it. A TMA warp waits on
// its own stage's mbarrier and sums from shared memory; a load warp sums
// from its registers and streams the rest of its rows. The two paths draw
// on the L2 side by side. With the pack in the L2 an SM's TMA unit alone
// is slower than its load pipes (the whole pack by TMA is slower than none
// of it at the flagship pack), and from HBM more of it by TMA is faster:
// the plan gives the copies three of a block's warps, or all of a smaller
// block (chip_gather_probe.py --sweep times every count). At the flagship
// pack on an NVIDIA H100 80GB HBM3 at 700 W it takes 2.645 us with the pack
// in the L2 and 5.442 us with the L2 flushed, against 3.105 and 7.359 us
// for the grid-per-column kernel it replaced and a 1.652 us bound
// (chip_gather_probe.py --parent; PERF.md has every shape).
//
// Two routes for y (the plan's stage_y). Where y's row and one ring stage
// fit a block's shared memory, the block stages y there, as above. Where
// they do not (T above about 55,000 floats: a dual LP over a nationwide
// registry's n = 100,000 agents), the block leaves y in global memory and
// each lane reads y[b, idx] through the read-only path (__ldg), from the
// L2, which holds a 400 KB row many times over; the block then has no y to
// wait on, so its warps meet only for their mbarriers (__syncwarp), and
// the whole of its shared memory is ring. The ranges, the lanes, the ring,
// the register prefetch, the butterfly and the order of every sum are the
// same on both routes, so at a shape both can run they give the same
// output bit for bit. The L2 route's reads are random 4-byte reads, a
// 32-byte sector each: it is slower than the staged route where both run
// (chip_smoke.py phase gather_nationwide times both).
//
// The sums are the earlier kernel's, bit for bit. A column is read by a group
// of G consecutive lanes (the largest of 8, 4, 2, 1 that divides kp / 4);
// lane g sums 16-byte vectors g, g + G, ... of its row (4 indices, 4 values)
// in order with one multiply-add per slot, and the group's lanes are then
// added by the xor butterfly; where a vector comes from (registers, a load,
// a TMA stage) does not change the order. Padding slots (value 0, index 0)
// add 0 * y[0], as in the reference, so a NaN in y[0] reaches every padded
// column. No float atomics: the order is fixed whatever the schedule. The
// output is [B, C] with no lane padding; idx is shared by all lanes, val is
// shared (val_bstride = 0) or per lane (val_bstride = C * kp).
//
// bf16 values (ell_gather_bf16_launch): the pack of a demoted operand
// (utils/precision.py) holds its values as bf16. Packs have kp % 8 == 0, so a
// bf16 row is a multiple of 16 bytes: a lane reads 8 values in one 16-byte
// load beside two int4 index loads, and each value is widened exactly to
// float32 (a bf16 is the upper half of a float32) before its multiply-add.
// The sum keeps the float32 path's order: this path runs G/2 lanes a column,
// and its lane h holds two float32 sums, those of the float32 path's lanes 2h
// and 2h + 1 (16-byte vectors 2u and 2u + 1 of its 8-value vector u, u = h,
// h + G/2, ...). The xor butterfly over the G/2 lanes on each sum, then their
// one add, is the float32 path's butterfly over G lanes step for step, so on
// lossless values the output is the float32 path's bit for bit.

#include <stdint.h>

#include "ell_gather.cuh"

namespace {

constexpr int kMaxThreads = 256;
// bytes of its row a lane of a load warp loads before it waits on y: 6
// float32 vectors (4 indices and 4 values each) or 4 bf16 ones (8 indices
// and 8 values), of the 7 a lane has at k_pad = 112
constexpr int kPrefetchBytes = 192;
// the shared memory a block may take on the H100 (227 KB)
constexpr int kBlockSmem = 232448;
// about five seconds at the H100's clock: far beyond any stage's arrival
constexpr long long kWaitTimeoutCycles = 10000000000LL;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the first phase of a stage's mbarrier; a stage that never lands
// is a fault: stop the kernel with an error after kWaitTimeoutCycles instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  if (mbar_try_wait(bar, 0u)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, 0u)) {
    if (clock64() - t0 > kWaitTimeoutCycles) __trap();
  }
}

// Put one warp's span of the pack in flight: initialise its mbarrier (one
// arrival, the issuing thread's, plus the copies' bytes), make it visible
// to the TMA unit, and issue the two 1-D bulk copies (each a multiple of 16
// bytes between 16-byte aligned ends) that complete on it.
__device__ __forceinline__ void issue_stage(uint32_t bar, uint32_t dst_idx, const void* src_idx,
                                            uint32_t idx_bytes, uint32_t dst_val,
                                            const void* src_val, uint32_t val_bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(idx_bytes + val_bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst_idx), "l"(src_idx), "r"(idx_bytes), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst_val), "l"(src_val), "r"(val_bytes), "r"(bar)
      : "memory");
}

// a bf16 value, the low or high half of a 32-bit word, widened to float32
__device__ __forceinline__ float bf16_lo(unsigned int w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int w) { return __uint_as_float(w & 0xffff0000u); }

// y[b, i]: from y's row staged in shared memory (YS), or from its row in
// global memory through the read-only path (the L2 route)
template <bool YS>
__device__ __forceinline__ float yat(const float* __restrict__ yr, int i) {
  if constexpr (YS) {
    return yr[i];
  } else {
    return __ldg(yr + i);
  }
}

// Multiply-add one 16-byte vector of slots into the lane's sum(s), in the
// slots' order: float32 (4 indices in ia, 4 values in w) or bf16 (8 indices
// in ia and ib, 8 values in w; the float32 path's lanes 2g and 2g + 1)
template <bool BF16, bool YS>
__device__ __forceinline__ void madd(float& acc0, float& acc1, const int4 ia, const int4 ib,
                                     const uint4 w, const float* __restrict__ yr) {
  if constexpr (!BF16) {
    acc0 += __uint_as_float(w.x) * yat<YS>(yr, ia.x);
    acc0 += __uint_as_float(w.y) * yat<YS>(yr, ia.y);
    acc0 += __uint_as_float(w.z) * yat<YS>(yr, ia.z);
    acc0 += __uint_as_float(w.w) * yat<YS>(yr, ia.w);
  } else {
    acc0 += bf16_lo(w.x) * yat<YS>(yr, ia.x);
    acc0 += bf16_hi(w.x) * yat<YS>(yr, ia.y);
    acc0 += bf16_lo(w.y) * yat<YS>(yr, ia.z);
    acc0 += bf16_hi(w.y) * yat<YS>(yr, ia.w);
    acc1 += bf16_lo(w.z) * yat<YS>(yr, ib.x);
    acc1 += bf16_hi(w.z) * yat<YS>(yr, ib.y);
    acc1 += bf16_lo(w.w) * yat<YS>(yr, ib.z);
    acc1 += bf16_hi(w.w) * yat<YS>(yr, ib.w);
  }
}

// y's row for lane b in shared memory: the row starts m floats past a 16-byte
// boundary, so element t sits at ys[m + t] and word w of the slot (elements
// 4w - m ... 4w - m + 3) is one aligned 16-byte load where it lies inside
// the row; the words at the row's two ends are loaded a float at a time.
// start() loads the first kYWords words a thread owns into registers; the
// caller then puts the pack in flight; finish() stores the words and stages
// the rest.
constexpr int kYWords = 2;

struct YStage {
  const float* row;
  int T, m, words;
  float4 r[kYWords];
  __device__ YStage(const float* row_, int T_) : row(row_), T(T_) {
    m = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    words = (m + T + 3) >> 2;
  }
  __device__ __forceinline__ float4 load(int w) const {
    const int t = 4 * w - m;
    if (t >= 0 && t + 4 <= T) return __ldg(reinterpret_cast<const float4*>(row + t));
    float4 v;
    v.x = (t >= 0 && t < T) ? __ldg(row + t) : 0.f;
    v.y = (t + 1 >= 0 && t + 1 < T) ? __ldg(row + t + 1) : 0.f;
    v.z = (t + 2 >= 0 && t + 2 < T) ? __ldg(row + t + 2) : 0.f;
    v.w = (t + 3 >= 0 && t + 3 < T) ? __ldg(row + t + 3) : 0.f;
    return v;
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < kYWords; ++k) {
      const int w = threadIdx.x + k * blockDim.x;
      if (w < words) r[k] = load(w);
    }
  }
  __device__ __forceinline__ void finish(float* ys) const {
    float4* s4 = reinterpret_cast<float4*>(ys);
#pragma unroll
    for (int k = 0; k < kYWords; ++k) {
      const int w = threadIdx.x + k * blockDim.x;
      if (w < words) s4[w] = r[k];
    }
    for (int w = threadIdx.x + kYWords * blockDim.x; w < words; w += blockDim.x) s4[w] = load(w);
  }
};

// A block's shared memory: tma_warps mbarriers (8 bytes each, padded to 16),
// the ring of tma_warps stages (a stage: the warp's 32 / G index rows, then
// its value rows), then, on the staged route only, y's row (T rounded up to
// 4 floats, and 4 more so the row can sit at its own 16-byte phase); the L2
// route has no y region. launch_plan (smem_bytes) sizes it the same way.
struct Layout {
  size_t ring, stage, idx, ys, total;
  __host__ __device__ Layout(int T, int kp, int es, int sc, int tma_warps, bool stage_y) {
    ring = ((size_t)tma_warps * 8 + 15) & ~(size_t)15;
    idx = (size_t)sc * kp * 4;
    stage = idx + (size_t)sc * kp * es;
    ys = ring + (size_t)tma_warps * stage;
    total = ys + (stage_y ? (size_t)(((T + 3) & ~3) + 4) * sizeof(float) : 0);
  }
};

// Block (i, b) sums columns [ca, ca + n) of lane b: ranges of per columns,
// one more for the first rem blocks of a lane. G lanes a column; warp w owns
// columns [w * 32 / G, (w + 1) * 32 / G) of the range; the last tma_warps
// warps take their spans by TMA. YS: y's row staged in shared memory, else
// read from the L2.
template <int G, bool BF16, bool YS>
__global__ void __launch_bounds__(kMaxThreads)
ell_gather_kernel(const int* __restrict__ idx, const void* __restrict__ val,
                  long long val_bstride, const float* __restrict__ y, float* __restrict__ out,
                  int T, int C, int kp, int per, int rem, int tma_warps) {
  constexpr int ES = BF16 ? 2 : 4;
  constexpr int SC = 32 / G;  // a warp's columns
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(T, kp, ES, SC, tma_warps, YS);
  const int b = blockIdx.y;
  const int ca = (int)blockIdx.x * per + min((int)blockIdx.x, rem);
  const int n = per + ((int)blockIdx.x < rem ? 1 : 0);
  const int g = threadIdx.x % G;
  const int j = threadIdx.x / G;
  const bool live = j < n;
  const int c = ca + (live ? j : n - 1);  // a lane past the range reads a live row, sums nothing
  const int warp = threadIdx.x >> 5;
  const int stage = warp - ((int)(blockDim.x >> 5) - tma_warps);  // < 0: a load warp
  const int w0 = warp * SC;                                       // the warp's first column
  const bool staged = stage >= 0 && w0 < n;
  const uint32_t bar = smem_u32(smem) + 8u * (uint32_t)max(stage, 0);
  const unsigned char* st = smem + L.ring + (size_t)max(stage, 0) * L.stage;
  const unsigned char* vbase =
      static_cast<const unsigned char*>(val) + (long long)b * val_bstride * ES;
  const int nvec = BF16 ? (kp >> 3) : (kp >> 2);
  // 1. y's first words (staged route): loads only
  const float* yrow = y + (long long)b * T;
  YStage yst(yrow, T);
  if constexpr (YS) yst.start();
  // 2. the pack in flight before y is waited on: a TMA warp's span by bulk
  // copies, a load warp's first kPrefetch vectors a lane into registers (a
  // vector past the row is clamped to its last one and not summed)
  constexpr int kPrefetch = kPrefetchBytes / (BF16 ? 48 : 32);
  int4 ia[kPrefetch], ib[kPrefetch];
  uint4 w[kPrefetch];
  const int4* i4 = reinterpret_cast<const int4*>(idx + (long long)c * kp);
  const uint4* v4 = reinterpret_cast<const uint4*>(vbase + (long long)c * kp * ES);
  if (stage >= 0) {
    if (staged && (threadIdx.x & 31) == 0) {
      const uint32_t cols = (uint32_t)min(SC, n - w0);
      issue_stage(bar, smem_u32(st), idx + (long long)(ca + w0) * kp, cols * kp * 4,
                  smem_u32(st + L.idx), vbase + (long long)(ca + w0) * kp * ES, cols * kp * ES);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      const int v = min(g + i * G, nvec - 1);
      if constexpr (BF16) {
        ia[i] = __ldg(i4 + 2 * v);
        ib[i] = __ldg(i4 + 2 * v + 1);
      } else {
        ia[i] = __ldg(i4 + v);
        ib[i] = ia[i];
      }
      w[i] = __ldg(v4 + v);
    }
  }
  // 3. y into shared memory (staged route); on the L2 route only a TMA
  // warp's lanes wait, for lane 0's mbarrier init
  const float* yr = yrow;
  if constexpr (YS) {
    float* ys = reinterpret_cast<float*>(smem + L.ys);
    yst.finish(ys);
    __syncthreads();
    yr = ys + yst.m;
  } else {
    __syncwarp();
  }
  // 4. the sums: lane g takes vectors g, g + G, ... in order, then the xor
  // butterfly adds the column's G lanes
  float acc0 = 0.f, acc1 = 0.f;
  if (stage >= 0) {
    if (staged) mbar_wait(bar);
    if (live) {
      const int jw = j - w0;  // the lane's column in the stage
      const int4* si = reinterpret_cast<const int4*>(st) + (size_t)jw * (kp >> 2);
      const uint4* sv = reinterpret_cast<const uint4*>(st + L.idx + (size_t)jw * kp * ES);
#pragma unroll 4
      for (int v = g; v < nvec; v += G) {
        if constexpr (BF16) {
          madd<BF16, YS>(acc0, acc1, si[2 * v], si[2 * v + 1], sv[v], yr);
        } else {
          const int4 a = si[v];
          madd<BF16, YS>(acc0, acc1, a, a, sv[v], yr);
        }
      }
    }
  } else if (live) {
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      if (g + i * G < nvec) madd<BF16, YS>(acc0, acc1, ia[i], ib[i], w[i], yr);
    }
#pragma unroll 4
    for (int v = g + kPrefetch * G; v < nvec; v += G) {
      int4 a, bb;
      if constexpr (BF16) {
        a = __ldg(i4 + 2 * v);
        bb = __ldg(i4 + 2 * v + 1);
      } else {
        a = __ldg(i4 + v);
        bb = a;
      }
      madd<BF16, YS>(acc0, acc1, a, bb, __ldg(v4 + v), yr);
    }
  }
  // every lane of the warp takes part (a column past the range adds 0)
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    acc0 += __shfl_xor_sync(0xffffffffu, acc0, o);
    if constexpr (BF16) acc1 += __shfl_xor_sync(0xffffffffu, acc1, o);
  }
  if (g == 0 && live) out[(long long)b * C + c] = BF16 ? acc0 + acc1 : acc0;
}

template <int G, bool BF16, bool YS>
cudaError_t launch(const int* idx, const void* val, long long val_bstride, const float* y,
                   float* out, int B, int T, int C, int kp, int threads, int blocks,
                   int tma_warps, cudaStream_t stream) {
  // blocks: the blocks of one lane; each lane has the same column ranges
  if (threads <= 0 || threads > kMaxThreads || (threads & 31) != 0 || blocks <= 0 ||
      blocks > C || tma_warps < 0 || tma_warps > threads / 32 ||
      (val_bstride != 0 && val_bstride != (long long)C * kp)) {
    return cudaErrorInvalidValue;
  }
  const int per = C / blocks;
  const int rem = C % blocks;
  if ((per + (rem > 0 ? 1 : 0)) * G > threads) return cudaErrorInvalidValue;
  const Layout L(T, kp, BF16 ? 2 : 4, 32 / G, tma_warps, YS);
  if (L.total > (size_t)kBlockSmem) return cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)B);
  ell_gather_kernel<G, BF16, YS><<<grid, threads, L.total, stream>>>(
      idx, val, val_bstride, y, out, T, C, kp, per, rem, tma_warps);
  return cudaGetLastError();
}

// the launch on y's route: staged in shared memory (stage_y != 0) or read
// from the L2
template <int G, bool BF16>
cudaError_t launch_route(int stage_y, const int* idx, const void* val, long long val_bstride,
                         const float* y, float* out, int B, int T, int C, int kp, int threads,
                         int blocks, int tma_warps, cudaStream_t stream) {
  if (stage_y != 0) {
    return launch<G, BF16, true>(idx, val, val_bstride, y, out, B, T, C, kp, threads, blocks,
                                 tma_warps, stream);
  }
  return launch<G, BF16, false>(idx, val, val_bstride, y, out, B, T, C, kp, threads, blocks,
                                tma_warps, stream);
}

template <int G, bool BF16>
cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(ell_gather_kernel<G, BF16, true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(ell_gather_kernel<G, BF16, false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockSmem);
}

}  // namespace

// Let every instance of the kernel (both routes of each) take up to 227 KB
// of dynamic shared memory on the current device. The wrapper calls it once
// per device before its first launch there, so no launch (which may be under
// graph capture) sets an attribute. Returns the first cudaError_t (0 on
// success).
extern "C" int ell_gather_setup() {
  const cudaError_t errs[] = {
      allow_smem<8, false>(), allow_smem<4, false>(), allow_smem<2, false>(),
      allow_smem<1, false>(), allow_smem<4, true>(),  allow_smem<2, true>(),
      allow_smem<1, true>(),
  };
  for (cudaError_t e : errs) {
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. idx and val start on 16-byte boundaries, kp is a multiple of
// 4, G (lanes per column: 1, 2, 4 or 8) divides kp / 4; threads (a block),
// blocks (a lane's) and tma_warps (a block's warps that take their spans by
// TMA) and stage_y (1: y's row staged in shared memory, 0: read from the
// L2) are the plan of kernels/ell_matvec.launch_plan. A plan the kernel
// cannot run returns cudaErrorInvalidValue; otherwise the launch's
// cudaError_t (0 on success).
extern "C" int ell_gather_launch(const void* idx, const void* val, long long val_bstride,
                                 const void* y, void* out, int B, int T, int C, int kp, int G,
                                 int threads, int blocks, int tma_warps, int stage_y,
                                 void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (kp <= 0 || (kp & 3) != 0 || (val_bstride & 3) != 0 ||
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) != 0 ||
      G <= 0 || (kp >> 2) % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* i = (const int*)idx;
  const float* yy = (const float*)y;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 8: return (int)launch_route<8, false>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    case 4: return (int)launch_route<4, false>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    case 2: return (int)launch_route<2, false>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    case 1: return (int)launch_route<1, false>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16-value entry point: val holds bf16 values (raw 16-bit words), kp is
// a multiple of 8, val_bstride a multiple of 8, idx and val start on 16-byte
// boundaries, and G (lanes per column: 1, 2 or 4, half the float32 path's)
// divides kp / 8; the plan, stage_y included, is launch_plan's with
// bf16=True. Returns the launch's cudaError_t.
extern "C" int ell_gather_bf16_launch(const void* idx, const void* val, long long val_bstride,
                                      const void* y, void* out, int B, int T, int C, int kp,
                                      int G, int threads, int blocks, int tma_warps, int stage_y,
                                      void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (kp <= 0 || (kp & 7) != 0 || (val_bstride & 7) != 0 ||
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(val)) & 15) != 0 ||
      G <= 0 || (kp >> 3) % G != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* i = (const int*)idx;
  const float* yy = (const float*)y;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (G) {
    case 4: return (int)launch_route<4, true>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    case 2: return (int)launch_route<2, true>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    case 1: return (int)launch_route<1, true>(stage_y, i, val, val_bstride, yy, o, B, T, C, kp, threads, blocks, tma_warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
