// Two-sided PDHG master for Hopper (sm_90a): the whole restarted PDHG solve of
//
//     min eps  s.t.  -eps <= M p - v <= eps,  sum(p) = 1,  p >= 0, eps >= 0
//
// in scaled coordinates, one thread block per lane, in one launch.
//
// Replaces: citizensassemblies_tpu/kernels/pdhg_megakernel.py:_two_sided_block_kernel
// (one Pallas program per lane computing one PDHG block: check_every
// iterations, the KKT of the current and the averaged iterate, restart to
// the better one, the omega rebalance, the sentinel freeze and the lane's
// active mask; an XLA while_loop around it launched one block at a time).
// Here the outer loop over blocks runs inside the kernel as well: a lane
// keeps running blocks until its own mask clears, so a solve is one launch
// and no host synchronisation happens between blocks. A lane that is done
// leaves its state untouched, bit for bit.
//
// What bounds it on the H100: bytes. Every iteration reads the packed matrix
// twice, once per matvec direction (C*kp*8 bytes slot-major for the adjoint
// gather, nnz*8 bytes type-major for the forward product), for about four
// flops per 8 bytes read. At the flagship (T=814, Cp=6144, kp<=112) that is
// about 10 MB per iteration, served from the 50 MB L2. With one block per
// lane, a lane can pull no more than one SM's share of L2 bandwidth: that,
// not the card's 3.35 TB/s, limits the B=1 master. Later designs (a cluster
// or cooperative grid over column tiles) lift it.
//
// Design, and why it differs from the TPU layout: the Pallas kernel builds a
// dense transposed expansion st[Cp, Tp] in VMEM and takes the forward
// product as a matrix product against it. At the flagship that is 22 MB,
// a hundred times the 227 KB of shared memory a block can have. Here:
//  * the T-length vectors (duals, their block-start copies, running sums,
//    averages, the gather source, the scaled eps column and the data rows,
//    kTVectors = 14 of them) and the C-length scratch p-bar live in shared memory;
//    the other C-length vectors (p, its average, its running sum, its
//    block-start copy) live in global scratch the wrapper allocates;
//  * the adjoint g[c] = sum_s vs[c,s] y[idx[c,s]] is ell_dot, the device
//    function the gather kernel uses, one thread per column over a
//    slot-major copy of the pack (coalesced reads);
//  * the forward product u[t] = sum_c vs[c,s] p[c] is a deterministic
//    gather over a type-major CSR transpose of the pack (one warp per type,
//    shuffle reduction), built once per solve with torch ops. A scatter-add
//    with atomics into a shared-memory accumulator would read the pack once
//    instead of twice, but it sums in a different order on every run; the
//    gather keeps runs reproducible, so a lane's iteration count is a
//    property of its inputs and frozen lanes compare bit for bit.
// All sums are float32 in a fixed order; min/max/clip propagate NaN as jnp
// does, so a non-finite lane is detected and quarantined as in the reference.

#include "ell_gather.cuh"
#include "two_sided_layout.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kStallBlocks = 64;    // mirrors lp_pdhg._STALL_BLOCKS

struct Params {
  const int* idxS;     // [kp, Cp] slot-major pack indices (shared by lanes)
  const float* vsS;    // [B, kp, Cp] slot-major scaled values
  const int* rowptr;   // [T+1] type-major transpose
  const int* colT;     // [nnz]
  const float* vsT;    // [B, nnz]
  const float* ecol;   // [B, T]
  const float* hlo;    // [B, T]
  const float* hup;    // [B, T]
  const float* arow;   // [B, Cp]
  float* p;            // [B, Cp] state in/out
  float* pav;          // [B, Cp]
  float* llo;          // [B, T]
  float* lup;
  float* llav;
  float* luav;
  float* scal;         // [B, S_N]
  int* iters;          // [B]
  float* p0;           // [B, Cp] scratch
  float* avn;
  float* ps;
  int T, Cp, kp, nnz, check_every, max_iters, sentinel;
};

struct Lane {
  const int* idxS;
  const float* vsS;
  const int* rowptr;
  const int* colT;
  const float* vsT;
  const float* arow;
  int T, Cp, kp;
};

// combined relative KKT residual of (x, eps, lo, up, mu); x in global
// memory, lo/up in shared memory; y and xs are shared scratch
__device__ float kkt(const Lane& L, const float* __restrict__ x, float eps,
                     const float* lo, const float* up, float mu, float* y,
                     float* xs, float* red, const float* ecol,
                     const float* hlo, const float* hup, float bs,
                     float cs_eps, float scale) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  // 0: sum ecol*(lo+up), 1: sum lo*hlo + up*hup, 2: sum min(g,0)^2,
  // 3: sum arow*x, 4: primal infeasibility^2 of the two-sided rows
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = tid; t < L.T; t += nth) {
    const float a = lo[t], b = up[t];
    y[t] = b - a;
    part[0] += ecol[t] * (a + b);
    part[1] += a * hlo[t] + b * hup[t];
  }
  for (int c = tid; c < L.Cp; c += nth) xs[c] = x[c];
  __syncthreads();
  for (int c = tid; c < L.Cp; c += nth) {
    const float g =
        ell_dot(L.idxS + c, L.vsS + c, 0, 1, L.kp, L.Cp, y) + mu * L.arow[c];
    const float m = min0(g);
    part[2] += m * m;
    part[3] += L.arow[c] * xs[c];
  }
  for (int t = warp; t < L.T; t += nw) {
    float u = 0.f;
    const int e1 = L.rowptr[t + 1];
    for (int e = L.rowptr[t] + lane; e < e1; e += 32) u += L.vsT[e] * xs[L.colT[e]];
    u = warp_sum(u);
    if (lane == 0) {
      const float ec = ecol[t] * eps;
      const float a = max0((-u - ec) - hlo[t]);
      const float b = max0((u - ec) - hup[t]);
      part[4] += a * a + b * b;
    }
  }
  block_sum(part, red);
  const float g_e = -part[0];
  const float req = part[3] - bs;
  const float pri = sqrtf(part[4] + req * req);
  const float gm = min0(g_e + cs_eps);
  const float dua = sqrtf(part[2] + gm * gm);
  const float pobj = cs_eps * eps;
  const float dobj = -part[1] - mu * bs;
  const float gap = fabsf(pobj - dobj);
  return (pri + dua) / scale + gap / (1.f + fabsf(pobj) + fabsf(dobj));
}

__global__ void __launch_bounds__(kThreads) two_sided_solve_kernel(Params prm) {
  extern __shared__ float sm[];
  const int T = prm.T, Cp = prm.Cp, kp = prm.kp;
  float* llo = sm;
  float* lup = llo + T;
  float* llo0 = lup + T;
  float* lup0 = llo0 + T;
  float* llav = lup0 + T;
  float* luav = llav + T;
  float* lls = luav + T;
  float* lus = lls + T;
  float* lla = lus + T;
  float* lua = lla + T;
  float* y = lua + T;
  float* ecol = y + T;
  float* hlo = ecol + T;
  float* hup = hlo + T;
  float* pb = hup + T;  // [Cp]
  float* red = pb + Cp;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nth >> 5;
  const long long bT = (long long)b * T, bC = (long long)b * Cp;

  Lane L;
  L.idxS = prm.idxS;
  L.vsS = prm.vsS + bC * kp;
  L.rowptr = prm.rowptr;
  L.colT = prm.colT;
  L.vsT = prm.vsT + (long long)b * prm.nnz;
  L.arow = prm.arow + bC;
  L.T = T;
  L.Cp = Cp;
  L.kp = kp;
  float* P = prm.p + bC;
  float* PAV = prm.pav + bC;
  float* P0 = prm.p0 + bC;
  float* AVN = prm.avn + bC;
  float* PS = prm.ps + bC;
  const int* rowptr = prm.rowptr;
  const int* colT = prm.colT;
  const float* vsT = L.vsT;
  const float* arow = L.arow;

  for (int t = tid; t < T; t += nth) {
    llo[t] = prm.llo[bT + t];
    lup[t] = prm.lup[bT + t];
    llav[t] = prm.llav[bT + t];
    luav[t] = prm.luav[bT + t];
    ecol[t] = prm.ecol[bT + t];
    hlo[t] = prm.hlo[bT + t];
    hup[t] = prm.hup[bT + t];
  }
  const float* sc = prm.scal + (long long)b * S_N;
  float eps = sc[S_EPS], mu = sc[S_MU], eav = sc[S_EAV], mav = sc[S_MAV];
  float res = sc[S_RES], omega = sc[S_OMEGA], pois = sc[S_POIS];
  float stall = sc[S_STALL], best = sc[S_BEST], since = sc[S_SINCE];
  const float bs = sc[S_BS], cs_eps = sc[S_CEPS], norm = sc[S_NORM];
  const float tol = sc[S_TOL], scale = sc[S_SCALE];
  int it = prm.iters[b];
  const int ce = prm.check_every;
  const float inv = 1.0f / (float)ce;
  __syncthreads();

  // the lane's active mask (a NaN residual compares false, so a poisoned
  // lane without the sentinel freezes here too)
  while (res > tol && it < prm.max_iters && pois == 0.f) {
    const float tau = 0.9f * omega / norm;
    const float sigma = 0.9f / (omega * norm);
    for (int c = tid; c < Cp; c += nth) {
      P0[c] = P[c];
      PS[c] = 0.f;
    }
    for (int t = tid; t < T; t += nth) {
      llo0[t] = llo[t];
      lup0[t] = lup[t];
      lls[t] = 0.f;
      lus[t] = 0.f;
    }
    const float eps0 = eps, mu0 = mu;
    float es = 0.f, ms = 0.f;
    __syncthreads();

    for (int k = 0; k < ce; ++k) {
      // adjoint source y = lup - llo and the eps gradient
      float ge[1] = {0.f};
      for (int t = tid; t < T; t += nth) {
        const float a = llo[t], u2 = lup[t];
        y[t] = u2 - a;
        ge[0] += ecol[t] * (a + u2);
      }
      block_sum(ge, red);
      const float eps_new = max0(eps - tau * (-ge[0] + cs_eps));
      const float eb = 2.f * eps_new - eps;
      // primal step, one column per thread; p-bar into shared memory
      float rq[1] = {0.f};
      for (int c = tid; c < Cp; c += nth) {
        const float g =
            ell_dot(L.idxS + c, L.vsS + c, 0, 1, kp, Cp, y) + mu * arow[c];
        const float pc = P[c];
        const float pn = max0(pc - tau * g);
        const float pbv = 2.f * pn - pc;
        P[c] = pn;
        PS[c] += pn;
        pb[c] = pbv;
        rq[0] += arow[c] * pbv;
      }
      block_sum(rq, red);
      const float mu_new = mu + sigma * (rq[0] - bs);
      // forward product and dual step, one warp per type
      for (int t = warp; t < T; t += nw) {
        float u = 0.f;
        const int e1 = rowptr[t + 1];
        for (int e = rowptr[t] + lane; e < e1; e += 32) u += vsT[e] * pb[colT[e]];
        u = warp_sum(u);
        if (lane == 0) {
          const float ec = ecol[t] * eb;
          const float ln = max0(llo[t] + sigma * ((-u - ec) - hlo[t]));
          const float un = max0(lup[t] + sigma * ((u - ec) - hup[t]));
          llo[t] = ln;
          lup[t] = un;
          lls[t] += ln;
          lus[t] += un;
        }
      }
      eps = eps_new;
      es += eps_new;
      mu = mu_new;
      ms += mu_new;
      __syncthreads();
    }

    // averaged iterate blended with the carried one
    for (int c = tid; c < Cp; c += nth) AVN[c] = (PAV[c] + PS[c] * inv) * 0.5f;
    for (int t = tid; t < T; t += nth) {
      lla[t] = (llav[t] + lls[t] * inv) * 0.5f;
      lua[t] = (luav[t] + lus[t] * inv) * 0.5f;
    }
    const float ea = (eav + es * inv) * 0.5f;
    const float ma = (mav + ms * inv) * 0.5f;
    __syncthreads();
    const float r_cur = kkt(L, P, eps, llo, lup, mu, y, pb, red, ecol, hlo,
                            hup, bs, cs_eps, scale);
    const float r_avg = kkt(L, AVN, ea, lla, lua, ma, y, pb, red, ecol, hlo,
                            hup, bs, cs_eps, scale);
    // restart to the average when it is strictly better (every thread
    // rewrites only the entries it reads below, so no barrier is needed)
    if (r_avg < r_cur) {
      for (int c = tid; c < Cp; c += nth) P[c] = AVN[c];
      for (int t = tid; t < T; t += nth) {
        llo[t] = lla[t];
        lup[t] = lua[t];
      }
      eps = ea;
      mu = ma;
    }
    const float res_new = nan_min(r_cur, r_avg);
    // primal-weight update from the block's movement norms
    float dd[2] = {0.f, 0.f};
    for (int c = tid; c < Cp; c += nth) {
      const float d = P[c] - P0[c];
      dd[0] += d * d;
    }
    for (int t = tid; t < T; t += nth) {
      const float d1 = llo[t] - llo0[t], d2 = lup[t] - lup0[t];
      dd[1] += d1 * d1 + d2 * d2;
    }
    block_sum(dd, red);
    const float dmu = mu - mu0;
    const float dx = sqrtf(dd[0]);
    const float dy = sqrtf(dd[1] + dmu * dmu);
    const bool moved = (dx > 1e-12f) && (dy > 1e-12f);
    const float omega_new =
        sqrtf(omega * clipf(dy / nan_max(dx, 1e-12f), 1e-4f, 1e4f));
    const float omega_out = moved ? clipf(omega_new, 1.f / 64.f, 64.f) : omega;

    // sentinel: a non-finite residual reverts the whole carry to the last
    // finite block and quarantines the lane
    const bool ok = !prm.sentinel || isfinite(res_new);
    if (ok) {
      for (int c = tid; c < Cp; c += nth) PAV[c] = AVN[c];
      for (int t = tid; t < T; t += nth) {
        llav[t] = lla[t];
        luav[t] = lua[t];
      }
      eav = ea;
      mav = ma;
      it += ce;
      res = res_new;
      omega = omega_out;
    } else {
      for (int c = tid; c < Cp; c += nth) P[c] = P0[c];
      for (int t = tid; t < T; t += nth) {
        llo[t] = llo0[t];
        lup[t] = lup0[t];
      }
      eps = eps0;
      mu = mu0;
    }
    if (prm.sentinel) {
      const bool improved = ok && (res < best);
      if (improved) {
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

  for (int t = tid; t < T; t += nth) {
    prm.llo[bT + t] = llo[t];
    prm.lup[bT + t] = lup[t];
    prm.llav[bT + t] = llav[t];
    prm.luav[bT + t] = luav[t];
  }
  if (tid == 0) {
    float* so = prm.scal + (long long)b * S_N;
    so[S_EPS] = eps;
    so[S_MU] = mu;
    so[S_EAV] = eav;
    so[S_MAV] = mav;
    so[S_RES] = res;
    so[S_OMEGA] = omega;
    so[S_POIS] = pois;
    so[S_STALL] = stall;
    so[S_BEST] = best;
    so[S_SINCE] = since;
    prm.iters[b] = it;
  }
}

}  // namespace

// Shared memory one lane needs at (T, Cp): the fit rule of
// two_sided_layout.cuh, which the Python gate reads as well.
static long long two_sided_smem_bytes(int T, int Cp) {
  return ((long long)kTVectors * T + Cp + kRedFloats) * (long long)sizeof(float);
}

// Plain C entry point for ctypes. Pointers are device pointers; stream is a
// cudaStream_t. Returns the cudaError_t of the launch (0 on success).
extern "C" int two_sided_solve_launch(
    const void* idxS, const void* vsS, const void* rowptr, const void* colT,
    const void* vsT, const void* ecol, const void* hlo, const void* hup,
    const void* arow, void* p, void* pav, void* llo, void* lup, void* llav,
    void* luav, void* scal, void* iters, void* p0, void* avn, void* ps,
    int B, int T, int Cp, int kp, int nnz, int check_every, int max_iters,
    int sentinel, void* stream) {
  if (B <= 0) return 0;
  const long long smem = two_sided_smem_bytes(T, Cp);
  if (smem > kMaxSmem || check_every <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      two_sided_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params prm;
  prm.idxS = (const int*)idxS;
  prm.vsS = (const float*)vsS;
  prm.rowptr = (const int*)rowptr;
  prm.colT = (const int*)colT;
  prm.vsT = (const float*)vsT;
  prm.ecol = (const float*)ecol;
  prm.hlo = (const float*)hlo;
  prm.hup = (const float*)hup;
  prm.arow = (const float*)arow;
  prm.p = (float*)p;
  prm.pav = (float*)pav;
  prm.llo = (float*)llo;
  prm.lup = (float*)lup;
  prm.llav = (float*)llav;
  prm.luav = (float*)luav;
  prm.scal = (float*)scal;
  prm.iters = (int*)iters;
  prm.p0 = (float*)p0;
  prm.avn = (float*)avn;
  prm.ps = (float*)ps;
  prm.T = T;
  prm.Cp = Cp;
  prm.kp = kp;
  prm.nnz = nnz;
  prm.check_every = check_every;
  prm.max_iters = max_iters;
  prm.sentinel = sentinel;
  two_sided_solve_kernel<<<B, kThreads, (size_t)smem, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
