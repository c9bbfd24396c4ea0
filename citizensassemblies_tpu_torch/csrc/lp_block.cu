// Generic-form PDHG LP for Hopper (sm_90a): the whole restarted PDHG solve of
//
//     min c'x  s.t.  G x <= h,  A x = b,  x >= 0
//
// in scaled coordinates (the wrapper equilibrates the stacked [G; A]), with
// G as packed ELL rows and A a small dense block, in one thread block and
// one launch.
//
// Replaces: citizensassemblies_tpu/kernels/pdhg_megakernel.py:_lp_block_kernel
// (one Pallas program computing one PDHG block of this LP: check_every
// iterations, the KKT of the current and the averaged iterate, restart to
// the better one, the omega rebalance, the sentinel freeze and the active
// mask; an XLA while_loop around it launched one block at a time). Here the
// loop over blocks runs inside the kernel too, so a solve is one launch with
// no host synchronisation between blocks.
//
// What bounds it on the H100: bytes. Every iteration and every KKT
// evaluation reads the pack twice, once per matvec direction (m1*kp*8 bytes
// slot-major for G x, nnz*8 bytes variable-major for G^T lam), for about
// four flops per 8 bytes read. At the flagship dual LP (m1 = 4096 panel
// rows, kp = 112, nv = 1728) that is about 7 MB per iteration, served from
// the 50 MB L2; one thread block pulls no more than one SM's share of it,
// so the time is that share, not HBM. The JAX consumer is one lane, so one
// block per solve is the simple design; spreading a solve over a cluster or
// a cooperative grid is later work.
//
// Design, and why it differs from the TPU layout: the Pallas kernel expands
// the scaled pack into a dense gd[m1p, nvp] per launch and takes G^T lam as
// a matrix product. At the flagship dual shape that is 28 MB, over a hundred
// times the 227 KB of shared memory a block can have. Here:
//  * the nv-length vectors (x, its block-start copy, its average, running
//    sum and blended average, x-bar, c: kNvVectors = 7), the dense A block,
//    the m2-length vectors and lam itself (kM1Vectors = 1) live in shared
//    memory: G^T lam reads lam at the pack's rows in random order on every
//    iteration, and from global memory each of those reads waits out the
//    L2's latency. The other m1-length vectors (lam's average, block-start
//    copy, running sum and blended average) are read in order and live in
//    global memory (the caller's buffer and the wrapper's scratch);
//  * G x is ell_dot, the gather kernel's device function, one thread per
//    row over a slot-major copy of the pack (coalesced reads), with x or
//    x-bar in shared memory;
//  * G^T lam is a deterministic gather over a variable-major CSR transpose
//    of the pack, built once per solve on the host: one warp per variable,
//    four of a lane's entries in flight at once, shuffle reduction. No
//    atomics, so the sum order is fixed, iteration counts are a property of
//    the inputs, and runs repeat bit for bit;
//  * A x and A^T mu are block reductions over the small dense block.
// All sums are float32 in a fixed order; min/max/clip propagate NaN as jnp
// does, and padding slots keep 0 * x[0], so a poisoned solve is detected and
// quarantined as in the reference.

#include "ell_gather.cuh"
#include "lp_layout.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kStallBlocks = 64;  // mirrors lp_pdhg._STALL_BLOCKS

struct Params {
  const int* idxS;    // [kp, m1] slot-major row pack
  const float* vsS;   // [kp, m1] scaled values
  const int* rowptr;  // [nv + 1] variable-major transpose
  const int* rowT;    // [nnz] row of each entry
  const float* vsT;   // [nnz]
  const float* As;    // [m2, nv] scaled equality block
  const float* cs;    // [nv]
  const float* hs;    // [m1]
  const float* bs;    // [m2]
  float* x;           // [nv] state in/out
  float* xav;
  float* lam;         // [m1] state in/out (staged in shared memory)
  float* lav;
  float* mu;          // [m2] state in/out
  float* mav;
  float* scal;        // [L_N]
  int* iters;         // [1]
  float* lam0;        // [m1] scratch
  float* ls;
  float* la;
  int nv, m1, m2, kp, check_every, max_iters, sentinel;
};

struct Lp {
  const int* idxS;
  const float* vsS;
  const int* rowptr;
  const int* rowT;
  const float* vsT;
  const float* As;  // shared memory
  const float* cs;  // shared memory
  const float* hs;  // global memory
  const float* bs;  // shared memory
  int nv, m1, m2, kp;
};

// (G^T y)[i] over the variable-major transpose, by one whole warp; every
// lane returns the sum. y is lam in shared memory, or its blended average
// in global memory for the KKT of the averaged iterate.
__device__ __forceinline__ float gt_dot(const Lp& P, int i, const float* y) {
  float g = 0.f;
  const int e1 = P.rowptr[i + 1];
#pragma unroll 4
  for (int e = P.rowptr[i] + (threadIdx.x & 31); e < e1; e += 32) g += P.vsT[e] * y[P.rowT[e]];
  return warp_sum(g);
}

// (A^T mu)[i]
__device__ __forceinline__ float at_dot(const Lp& P, int i, const float* mu) {
  float a = 0.f;
  for (int r = 0; r < P.m2; ++r) a += P.As[r * P.nv + i] * mu[r];
  return a;
}

// combined relative KKT residual at (x, lam, mu); x and mu in shared
// memory, lam in shared or global memory
__device__ float kkt(const Lp& P, const float* x, const float* lam,
                     const float* mu, float* red, float scale) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  // 0: sum max(Gx - h, 0)^2, 1: sum lam * h, 2: sum min(grad, 0)^2,
  // 3: sum c * x
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = tid; j < P.m1; j += nth) {
    const float r = max0(ell_dot(P.idxS + j, P.vsS + j, 0, 1, P.kp, P.m1, x) - P.hs[j]);
    part[0] += r * r;
    part[1] += lam[j] * P.hs[j];
  }
  for (int i = warp; i < P.nv; i += nw) {
    const float g = gt_dot(P, i, lam);
    if (lane == 0) {
      const float m = min0((P.cs[i] + g) + at_dot(P, i, mu));
      part[2] += m * m;
      part[3] += P.cs[i] * x[i];
    }
  }
  block_sum(part, red);
  float eq2 = 0.f, mub = 0.f;
  for (int r = 0; r < P.m2; ++r) {
    float ax[1] = {0.f};
    for (int i = tid; i < P.nv; i += nth) ax[0] += P.As[r * P.nv + i] * x[i];
    block_sum(ax, red);
    const float d = ax[0] - P.bs[r];
    eq2 += d * d;
    mub += mu[r] * P.bs[r];
  }
  const float pri = sqrtf(part[0] + eq2);
  const float dua = sqrtf(part[2]);
  const float pobj = part[3];
  const float dobj = -part[1] - mub;
  const float gap = fabsf(pobj - dobj);
  return (pri + dua) / scale + gap / (1.f + fabsf(pobj) + fabsf(dobj));
}

__global__ void __launch_bounds__(kThreads) lp_solve_kernel(Params prm) {
  extern __shared__ float sm[];
  const int nv = prm.nv, m1 = prm.m1, m2 = prm.m2;
  float* x = sm;
  float* x0 = x + nv;
  float* xav = x0 + nv;
  float* xs = xav + nv;
  float* xa = xs + nv;
  float* xb = xa + nv;
  float* cs = xb + nv;
  float* As = cs + nv;  // [m2 * nv]
  float* mu = As + m2 * nv;
  float* mu0 = mu + m2;
  float* mav = mu0 + m2;
  float* ms = mav + m2;
  float* ma = ms + m2;
  float* bs = ma + m2;
  float* lam = bs + m2;  // [m1]
  float* red = lam + m1;

  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  float* lav = prm.lav;
  float* lam0 = prm.lam0;
  float* ls = prm.ls;
  float* la = prm.la;
  const float* hs = prm.hs;

  for (int i = tid; i < nv; i += nth) {
    x[i] = prm.x[i];
    xav[i] = prm.xav[i];
    cs[i] = prm.cs[i];
  }
  for (int j = tid; j < m1; j += nth) lam[j] = prm.lam[j];
  for (int e = tid; e < m2 * nv; e += nth) As[e] = prm.As[e];
  for (int r = tid; r < m2; r += nth) {
    mu[r] = prm.mu[r];
    mav[r] = prm.mav[r];
    bs[r] = prm.bs[r];
  }
  const Lp P{prm.idxS, prm.vsS, prm.rowptr, prm.rowT, prm.vsT, As, cs, hs, bs,
             nv, m1, m2, prm.kp};
  const float* sc = prm.scal;
  float res = sc[L_RES], omega = sc[L_OMEGA], pois = sc[L_POIS];
  float stall = sc[L_STALL], best = sc[L_BEST], since = sc[L_SINCE];
  const float norm = sc[L_NORM], scale = sc[L_SCALE], tol = sc[L_TOL];
  int it = prm.iters[0];
  const int ce = prm.check_every;
  const float inv = 1.0f / (float)ce;
  __syncthreads();

  // the active mask (a NaN residual compares false, so a poisoned solve
  // without the sentinel stops here too)
  while (res > tol && it < prm.max_iters && pois == 0.f) {
    const float tau = 0.9f * omega / norm;
    const float sigma = 0.9f / (omega * norm);
    for (int i = tid; i < nv; i += nth) {
      x0[i] = x[i];
      xs[i] = 0.f;
    }
    for (int j = tid; j < m1; j += nth) {
      lam0[j] = lam[j];
      ls[j] = 0.f;
    }
    for (int r = tid; r < m2; r += nth) {
      mu0[r] = mu[r];
      ms[r] = 0.f;
    }
    __syncthreads();

    for (int k = 0; k < ce; ++k) {
      // primal step, one warp per variable; x-bar into shared memory
      for (int i = warp; i < nv; i += nw) {
        const float g = gt_dot(P, i, lam);
        if (lane == 0) {
          const float grad = (cs[i] + g) + at_dot(P, i, mu);
          const float xo = x[i];
          const float xn = max0(xo - tau * grad);
          x[i] = xn;
          xs[i] += xn;
          xb[i] = 2.f * xn - xo;
        }
      }
      __syncthreads();
      // equality rows at x-bar and the mu step (mu is next read after the
      // barrier that closes this iteration)
      for (int r = 0; r < m2; ++r) {
        float ax[1] = {0.f};
        for (int i = tid; i < nv; i += nth) ax[0] += As[r * nv + i] * xb[i];
        block_sum(ax, red);
        if (tid == 0) {
          const float mn = mu[r] + sigma * (ax[0] - bs[r]);
          mu[r] = mn;
          ms[r] += mn;
        }
      }
      // dual step, one thread per packed row
      for (int j = tid; j < m1; j += nth) {
        const float u = ell_dot(P.idxS + j, P.vsS + j, 0, 1, P.kp, m1, xb);
        const float ln = max0(lam[j] + sigma * (u - hs[j]));
        lam[j] = ln;
        ls[j] += ln;
      }
      __syncthreads();
    }

    // averaged iterate blended with the carried one
    for (int i = tid; i < nv; i += nth) xa[i] = (xav[i] + xs[i] * inv) * 0.5f;
    for (int j = tid; j < m1; j += nth) la[j] = (lav[j] + ls[j] * inv) * 0.5f;
    for (int r = tid; r < m2; r += nth) ma[r] = (mav[r] + ms[r] * inv) * 0.5f;
    __syncthreads();
    const float r_cur = kkt(P, x, lam, mu, red, scale);
    const float r_avg = kkt(P, xa, la, ma, red, scale);
    // restart to the average when it is strictly better
    if (r_avg < r_cur) {
      for (int i = tid; i < nv; i += nth) x[i] = xa[i];
      for (int j = tid; j < m1; j += nth) lam[j] = la[j];
      for (int r = tid; r < m2; r += nth) mu[r] = ma[r];
    }
    __syncthreads();
    const float res_new = nan_min(r_cur, r_avg);
    // primal-weight update from the block's movement norms (the mu part is
    // read before the reduction, whose barriers order it before any write)
    float dmu2 = 0.f;
    for (int r = 0; r < m2; ++r) {
      const float d = mu[r] - mu0[r];
      dmu2 += d * d;
    }
    float dd[2] = {0.f, 0.f};
    for (int i = tid; i < nv; i += nth) {
      const float d = x[i] - x0[i];
      dd[0] += d * d;
    }
    for (int j = tid; j < m1; j += nth) {
      const float d = lam[j] - lam0[j];
      dd[1] += d * d;
    }
    block_sum(dd, red);
    const float dx = sqrtf(dd[0]);
    const float dy = sqrtf(dd[1] + dmu2);
    const bool moved = (dx > 1e-12f) && (dy > 1e-12f);
    const float omega_new =
        sqrtf(omega * clipf(dy / nan_max(dx, 1e-12f), 1e-4f, 1e4f));
    const float omega_out = moved ? clipf(omega_new, 1.f / 64.f, 64.f) : omega;

    // sentinel: a non-finite residual reverts the whole carry to the block
    // start and quarantines the solve
    const bool ok = !prm.sentinel || isfinite(res_new);
    if (ok) {
      for (int i = tid; i < nv; i += nth) xav[i] = xa[i];
      for (int j = tid; j < m1; j += nth) lav[j] = la[j];
      for (int r = tid; r < m2; r += nth) mav[r] = ma[r];
      it += ce;
      res = res_new;
      omega = omega_out;
    } else {
      for (int i = tid; i < nv; i += nth) x[i] = x0[i];
      for (int j = tid; j < m1; j += nth) lam[j] = lam0[j];
      for (int r = tid; r < m2; r += nth) mu[r] = mu0[r];
    }
    if (prm.sentinel) {
      if (ok && res < best) {
        best = res;
        since = 0.f;
      } else {
        since += 1.f;
      }
      if (!ok) pois = 1.f;
      if (since >= (float)kStallBlocks) stall = 1.f;
    }
    __syncthreads();
  }

  for (int i = tid; i < nv; i += nth) {
    prm.x[i] = x[i];
    prm.xav[i] = xav[i];
  }
  for (int j = tid; j < m1; j += nth) prm.lam[j] = lam[j];
  for (int r = tid; r < m2; r += nth) {
    prm.mu[r] = mu[r];
    prm.mav[r] = mav[r];
  }
  if (tid == 0) {
    float* so = prm.scal;
    so[L_RES] = res;
    so[L_OMEGA] = omega;
    so[L_POIS] = pois;
    so[L_STALL] = stall;
    so[L_BEST] = best;
    so[L_SINCE] = since;
    prm.iters[0] = it;
  }
}

}  // namespace

// Shared memory one solve needs at (nv, m1, m2): the fit rule of
// lp_layout.cuh, which the Python gate reads as well.
static long long lp_smem_bytes(int nv, int m1, int m2) {
  return ((long long)kNvVectors * nv + (long long)m2 * nv +
          (long long)kM2Vectors * m2 + (long long)kM1Vectors * m1 +
          kLpRedFloats) *
         (long long)sizeof(float);
}

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int lp_solve_launch(
    const void* idxS, const void* vsS, const void* rowptr, const void* rowT,
    const void* vsT, const void* As, const void* cs, const void* hs,
    const void* bs, void* x, void* xav, void* lam, void* lav, void* mu,
    void* mav, void* scal, void* iters, void* lam0, void* ls, void* la,
    int nv, int m1, int m2, int kp, int check_every, int max_iters,
    int sentinel, void* stream) {
  const long long smem = lp_smem_bytes(nv, m1, m2);
  if (smem > kLpMaxSmem || check_every <= 0 || nv <= 0 || m1 < 0 || m2 < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lp_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params prm;
  prm.idxS = (const int*)idxS;
  prm.vsS = (const float*)vsS;
  prm.rowptr = (const int*)rowptr;
  prm.rowT = (const int*)rowT;
  prm.vsT = (const float*)vsT;
  prm.As = (const float*)As;
  prm.cs = (const float*)cs;
  prm.hs = (const float*)hs;
  prm.bs = (const float*)bs;
  prm.x = (float*)x;
  prm.xav = (float*)xav;
  prm.lam = (float*)lam;
  prm.lav = (float*)lav;
  prm.mu = (float*)mu;
  prm.mav = (float*)mav;
  prm.scal = (float*)scal;
  prm.iters = (int*)iters;
  prm.lam0 = (float*)lam0;
  prm.ls = (float*)ls;
  prm.la = (float*)la;
  prm.nv = nv;
  prm.m1 = m1;
  prm.m2 = m2;
  prm.kp = kp;
  prm.check_every = check_every;
  prm.max_iters = max_iters;
  prm.sentinel = sentinel;
  lp_solve_kernel<<<1, kThreads, (size_t)smem, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
