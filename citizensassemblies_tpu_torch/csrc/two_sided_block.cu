// Two-sided PDHG master for Hopper (sm_90a): the whole restarted PDHG solve of
//
//     min eps  s.t.  -eps <= M p - v <= eps,  sum(p) = 1,  p >= 0, eps >= 0
//
// in scaled coordinates, in one cooperative launch that spreads each lane
// over a group of thread blocks.
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
// What bounds it on the H100. Every iteration reads the whole pack, in two
// layouts (row-major [Cp, kp] for the adjoint gather, a type-major CSR for
// the forward product): about 10 MB at the flagship (T=814, Cp=6144,
// kp=112), for about four flops per 8 bytes, served from the 50 MB L2. The
// first port ran one block per lane and so pulled that through one SM's
// share of L2 bandwidth (~55 GB/s, 190 us an iteration). Spread over all
// 132 SMs with each block's share resident in shared memory, an iteration
// moves only the staged y and p-bar (3.7 MB over the card) and takes about
// 9.5 us (chip_smoke.py, PERF.md): two group barriers of about 1.04 us each,
// and the rest latency, not bandwidth: per iteration two L2 round trips
// for the staged vectors and two for the fixed-order sums of 132
// partials, about fourteen block-wide __syncthreads, and the serial
// gathers of the block's own columns and types.
//
// Design:
//  * the launch plan (blocks per lane, each block's contiguous column tile
//    and type tile, the types balanced by their CSR entries) is computed on
//    the host from this file's layout header, the SM count and the
//    occupancy that two_sided_occupancy reports, and passed in;
//  * a block owns its columns (adjoint, primal step, p, its average, its
//    running sum, its block-start copy) and its types (forward product, dual
//    step, the duals and their averages); that state lives in global
//    memory, touched by its owner only;
//  * a block keeps its share of the pack (its columns' rows of the
//    row-major pack, its types' run of the CSR) resident in shared memory
//    for the whole solve when the plan says it fits (the flagship at B=1:
//    about 80 KB a block), so the pack is read from memory once per launch;
//    otherwise it streams that share from L2 on every pass;
//  * what other blocks read goes through global memory (L2) after a group
//    barrier: y = up - lo (T floats) and p-bar (Cp floats), each staged
//    into shared memory by every block of the lane before it gathers;
//  * the adjoint g[c] = sum_s vs[c,s] y[idx[c,s]] takes one warp per column
//    over the row-major pack (coalesced), slots strided over the lanes and
//    summed by the xor butterfly; the forward product u[t] = sum_c vs[c,s]
//    p[c] takes one or more warps per type over the CSR, parts summed in
//    order;
//  * scalar sums (the eps gradient, the equality row, the five KKT terms,
//    the two movement norms) are block sums written to a [slots, blocks]
//    scratch and, after the barrier, summed by every block in block order
//    (grid_sync.cuh): every block holds bitwise the same scalars and takes
//    the same decisions (loop, restart, sentinel, stall), and a lane's
//    iteration count is a property of its inputs. No float atomics.
//  * lanes finish at different times, so each lane's blocks synchronise on
//    a barrier of their own rather than on the whole grid.
// All sums are float32 in a fixed order; min/max/clip propagate NaN as jnp
// does, so a non-finite lane is detected and quarantined as in the reference.

#include "grid_sync.cuh"
#include "two_sided_layout.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kStallBlocks = 64;  // mirrors lp_pdhg._STALL_BLOCKS
// partial-sum slots: the eps gradient, the equality row, the KKT's first
// three and last two terms, the two movement norms
constexpr int P_GE = 0;
constexpr int P_RQ = 1;
constexpr int P_K1 = 2;
constexpr int P_K2 = 5;
constexpr int P_DD = 7;
static_assert(P_DD + 2 == kSlots, "slots and layout header disagree");
static_assert(kRedFloats >= 8 * 33 + 32 + 16, "reduction scratch too small");

struct Params {
  const int* idx;      // [Cp, kp] pack indices (shared by lanes)
  const float* vals;   // [B, Cp, kp] scaled values
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
  float* scratch;      // [B, lane scratch] (two_sided_layout.cuh)
  unsigned long long* bar;  // [B], zero
  const int* plan;     // [2 * (nb + 1)]: column bounds, then type bounds
  int T, Cp, kp, nnz, nb, tile_floats, check_every, max_iters, sentinel;
};

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

// floats of one lane's global scratch (two_sided_layout.cuh)
__host__ __device__ __forceinline__ long long lane_scratch(int T, int Cp, int nb) {
  return round_up(kScratchCVectors * round_up(Cp, kAlignFloats) +
                      kScratchTVectors * round_up(T, kAlignFloats) + kSlots * nb,
                  kAlignFloats);
}

// one block's view of its lane. Everything it owns is indexed locally:
// column c = c0 + cl, type t = t0 + tl; its share of the pack at cl * kp of
// tidx/tval and, for CSR entry e, at e - e0 of tcol/tvs.
struct Ctx {
  const int* tidx;
  const float* tval;
  const int* rowptr;
  const int* tcol;
  const float* tvs;
  const float* ecol;  // [nt], and hlo, hup
  const float* hlo;
  const float* hup;
  const float* arow;  // [nc]
  float* PBK;   // the KKT's published x (global, all Cp)
  float* YK;    // the KKT's published y (global, all T)
  float* part;  // [kSlots, nb]
  float* ys;    // shared [T]
  float* pbs;   // shared [Cp]
  float* red;   // shared [kRedFloats]
  GroupBarrier bar;
  int T, Cp, kp, nb, j, c0, nc, t0, nt, e0;
};

constexpr int kGroupRed = 8 * 33 + 32;  // the group sums' slice of red

// the adjoint's gather for the block's local column cl, summed over the
// warp (every lane holds it)
__device__ __forceinline__ float col_dot(const Ctx& X, int cl, int lane) {
  const long long o = (long long)cl * X.kp;
  return warp_sum(ell_dot(X.tidx + o, X.tval + o, lane, 32, X.kp, 1, X.ys));
}

// u[t] = sum over type t's CSR entries of tvs[e] * pbs[tcol[e]] for the
// block's types; f(tl, u) runs once per local type on one thread. A type
// gets kWarps / nt warps when the tile has fewer types than warps, and
// their part sums are added in part order.
template <class F>
__device__ __forceinline__ void forward(const Ctx& X, F f) {
  const int nt = X.nt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int parts = (nt == 0 || nt >= kWarps) ? 1 : kWarps / nt;
  float* tpart = X.red + 8 * 33;
  for (int job = warp; job < nt * parts; job += kWarps) {
    const int tl = job / parts, q = job % parts;
    const int t = X.t0 + tl;
    const int e1 = X.rowptr[t + 1] - X.e0;
    float u = 0.f;
#pragma unroll 4
    for (int e = X.rowptr[t] - X.e0 + q * 32 + lane; e < e1; e += parts * 32) {
      u += X.tvs[e] * X.pbs[X.tcol[e]];
    }
    u = warp_sum(u);
    if (lane == 0) {
      if (parts == 1) {
        f(tl, u);
      } else {
        tpart[job] = u;
      }
    }
  }
  if (parts > 1) {
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float u = 0.f;
      for (int q = 0; q < parts; ++q) u += tpart[threadIdx.x * parts + q];
      f((int)threadIdx.x, u);
    }
    __syncthreads();
  }
}

// this block's partials of N slots starting at `slot`, then the lane's
// totals; meanwhile the block stages n floats src -> dst
template <int N>
__device__ __forceinline__ void lane_sum(Ctx& X, float (&v)[N], int slot, float* dst = nullptr,
                                         const float* src = nullptr, int n = 0) {
  block_sum(v, X.red);  // ends in __syncthreads after every global write
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) X.part[(slot + i) * X.nb + X.j] = v[i];
  }
  group_sync(X.bar, true);
  group_sum<N, kThreads>(X.part + slot * X.nb, X.nb, v, X.red + kGroupRed, dst, src, n);
}

// combined relative KKT residual of (x, eps, lo, up, mu): x over the
// block's columns, lo/up over its types (local views)
__device__ float kkt(Ctx& X, const float* x, float eps, const float* lo, const float* up,
                     float mu, float bs, float cs_eps, float scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // sum ecol*(lo+up), sum lo*hlo + up*hup, sum arow*x
  float k1[3] = {0.f, 0.f, 0.f};
  for (int tl = tid; tl < X.nt; tl += kThreads) {
    const float a = lo[tl], b = up[tl];
    X.YK[X.t0 + tl] = b - a;
    k1[0] += X.ecol[tl] * (a + b);
    k1[1] += a * X.hlo[tl] + b * X.hup[tl];
  }
  for (int cl = tid; cl < X.nc; cl += kThreads) {
    const float xv = x[cl];
    X.PBK[X.c0 + cl] = xv;
    k1[2] += X.arow[cl] * xv;
  }
  lane_sum(X, k1, P_K1, X.ys, X.YK, X.T);
  stage_floats(X.pbs, X.PBK, X.Cp, 0, kThreads);
  __syncthreads();
  // sum min(g,0)^2, primal infeasibility^2 of the two-sided rows
  float k2[2] = {0.f, 0.f};
  for (int cl = warp; cl < X.nc; cl += kWarps) {
    const float g = col_dot(X, cl, lane) + mu * X.arow[cl];
    const float m = min0(g);
    if (lane == 0) k2[0] += m * m;
  }
  float pinf = 0.f;
  forward(X, [&](int tl, float u) {
    const float ec = X.ecol[tl] * eps;
    const float a = max0((-u - ec) - X.hlo[tl]);
    const float b = max0((u - ec) - X.hup[tl]);
    pinf += a * a + b * b;
  });
  k2[1] = pinf;
  lane_sum(X, k2, P_K2);
  const float g_e = -k1[0];
  const float req = k1[2] - bs;
  const float pri = sqrtf(k2[1] + req * req);
  const float gm = min0(g_e + cs_eps);
  const float dua = sqrtf(k2[0] + gm * gm);
  const float pobj = cs_eps * eps;
  const float dobj = -k1[1] - mu * bs;
  const float gap = fabsf(pobj - dobj);
  return (pri + dua) / scale + gap / (1.f + fabsf(pobj) + fabsf(dobj));
}

// floats of shared memory a resident block needs beyond the staged vectors:
// its share of both pack layouts and its column and type state
__host__ __device__ __forceinline__ int resident_floats(int nc, int nt, int ne, int kp) {
  return 2 * (nc * kp + ne) + kOwnCVectors * nc + kOwnTVectors * nt;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads) two_sided_solve_kernel(Params prm) {
  extern __shared__ __align__(16) float sm[];
  const int T = prm.T, Cp = prm.Cp, kp = prm.kp, nb = prm.nb;
  const int T4 = round_up(T, kAlignFloats), C4 = round_up(Cp, kAlignFloats);
  const int b = blockIdx.x / nb, j = blockIdx.x % nb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bT = (long long)b * T, bC = (long long)b * Cp;
  float* scr = prm.scratch + (long long)b * lane_scratch(T, Cp, nb);

  Ctx X;
  X.c0 = prm.plan[j];
  X.nc = prm.plan[j + 1] - X.c0;
  X.t0 = prm.plan[nb + 1 + j];
  X.nt = prm.plan[nb + 2 + j] - X.t0;
  X.rowptr = prm.rowptr;
  X.e0 = prm.rowptr[X.t0];
  const int c0 = X.c0, nc = X.nc, t0 = X.t0, nt = X.nt;
  const int ne = prm.rowptr[t0 + nt] - X.e0;
  X.ys = sm;
  X.pbs = sm + T4;
  X.red = X.pbs + C4;
  // the lane's global state, from this block's first column and type
  float* gP = prm.p + bC + c0;
  float* gPAV = prm.pav + bC + c0;
  float* gllo = prm.llo + bT + t0;
  float* glup = prm.lup + bT + t0;
  float* gllav = prm.llav + bT + t0;
  float* gluav = prm.luav + bT + t0;
  const float* garow = prm.arow + bC + c0;
  const float* gecol = prm.ecol + bT + t0;
  const float* ghlo = prm.hlo + bT + t0;
  const float* ghup = prm.hup + bT + t0;
  const int* gidx = prm.idx + (long long)c0 * kp;
  const float* gval = prm.vals + bC * kp + (long long)c0 * kp;
  const int* gcol = prm.colT + X.e0;
  const float* gvs = prm.vsT + (long long)b * prm.nnz + X.e0;
  // global scratch: the published vectors, the partials, and the column
  // and type state a streaming block keeps there
  float* PB = scr + 3 * C4;
  X.PBK = PB + C4;
  float* Y = X.PBK + C4 + 6 * T4;
  X.YK = Y + T4;
  X.part = X.YK + T4;
  float *P, *PAV, *P0, *PS, *AVN, *arow;
  float *llo, *lup, *llav, *luav, *llo0, *lup0, *lls, *lus, *lla, *lua, *ecol, *hlo, *hup;
  if (kResident) {
    // the block's share of the pack and its own state, in shared memory
    // for the whole solve
    if (resident_floats(nc, nt, ne, kp) > prm.tile_floats) __trap();  // the plan is wrong
    int* sidx = reinterpret_cast<int*>(X.red + kRedFloats);
    float* sval = reinterpret_cast<float*>(sidx + nc * kp);
    int* scol = reinterpret_cast<int*>(sval + nc * kp);
    float* svs = reinterpret_cast<float*>(scol + ne);
    P = svs + ne;
    PAV = P + nc;
    P0 = PAV + nc;
    PS = P0 + nc;
    AVN = PS + nc;
    arow = AVN + nc;
    llo = arow + nc;
    lup = llo + nt;
    llav = lup + nt;
    luav = llav + nt;
    llo0 = luav + nt;
    lup0 = llo0 + nt;
    lls = lup0 + nt;
    lus = lls + nt;
    lla = lus + nt;
    lua = lla + nt;
    ecol = lua + nt;
    hlo = ecol + nt;
    hup = hlo + nt;
    for (int i = tid; i < nc * kp; i += kThreads) {
      sidx[i] = __ldg(gidx + i);
      sval[i] = __ldg(gval + i);
    }
    for (int i = tid; i < ne; i += kThreads) {
      scol[i] = __ldg(gcol + i);
      svs[i] = __ldg(gvs + i);
    }
    for (int i = tid; i < nc; i += kThreads) {
      P[i] = gP[i];
      PAV[i] = gPAV[i];
      arow[i] = garow[i];
    }
    for (int i = tid; i < nt; i += kThreads) {
      llo[i] = gllo[i];
      lup[i] = glup[i];
      llav[i] = gllav[i];
      luav[i] = gluav[i];
      ecol[i] = gecol[i];
      hlo[i] = ghlo[i];
      hup[i] = ghup[i];
    }
    X.tidx = sidx;
    X.tval = sval;
    X.tcol = scol;
    X.tvs = svs;
    __syncthreads();
  } else {
    X.tidx = gidx;
    X.tval = gval;
    X.tcol = gcol;
    X.tvs = gvs;
    P = gP;
    PAV = gPAV;
    P0 = scr + c0;
    PS = P0 + C4;
    AVN = PS + C4;
    arow = const_cast<float*>(garow);
    llo = gllo;
    lup = glup;
    llav = gllav;
    luav = gluav;
    llo0 = X.PBK + C4 + t0;
    lup0 = llo0 + T4;
    lls = lup0 + T4;
    lus = lls + T4;
    lla = lus + T4;
    lua = lla + T4;
    ecol = const_cast<float*>(gecol);
    hlo = const_cast<float*>(ghlo);
    hup = const_cast<float*>(ghup);
  }
  X.ecol = ecol;
  X.hlo = hlo;
  X.hup = hup;
  X.arow = arow;
  X.bar.count = prm.bar + b;
  X.bar.target = 0;
  X.bar.nblocks = (unsigned int)nb;
  X.T = T;
  X.Cp = Cp;
  X.kp = kp;
  X.nb = nb;
  X.j = j;

  const float* sc = prm.scal + (long long)b * S_N;
  float eps = sc[S_EPS], mu = sc[S_MU], eav = sc[S_EAV], mav = sc[S_MAV];
  float res = sc[S_RES], omega = sc[S_OMEGA], pois = sc[S_POIS];
  float stall = sc[S_STALL], best = sc[S_BEST], since = sc[S_SINCE];
  const float bs = sc[S_BS], cs_eps = sc[S_CEPS], norm = sc[S_NORM];
  const float tol = sc[S_TOL], scale = sc[S_SCALE];
  int it = prm.iters[b];
  const int ce = prm.check_every;
  const float inv = 1.0f / (float)ce;

  // the lane's active mask (a NaN residual compares false, so a poisoned
  // lane without the sentinel freezes here too); every block of the lane
  // holds the same scalars, so all of them leave the loop together
  while (res > tol && it < prm.max_iters && pois == 0.f) {
    const float tau = 0.9f * omega / norm;
    const float sigma = 0.9f / (omega * norm);
    for (int cl = tid; cl < nc; cl += kThreads) {
      P0[cl] = P[cl];
      PS[cl] = 0.f;
    }
    for (int tl = tid; tl < nt; tl += kThreads) {
      llo0[tl] = llo[tl];
      lup0[tl] = lup[tl];
      lls[tl] = 0.f;
      lus[tl] = 0.f;
    }
    const float eps0 = eps, mu0 = mu;
    float es = 0.f, ms = 0.f;
    __syncthreads();

    for (int k = 0; k < ce; ++k) {
      // y = up - lo over the block's types, and the eps gradient; after the
      // barrier the lane's y is staged while the gradient is summed
      float ge[1] = {0.f};
      for (int tl = tid; tl < nt; tl += kThreads) {
        const float a = llo[tl], u2 = lup[tl];
        Y[t0 + tl] = u2 - a;
        ge[0] += ecol[tl] * (a + u2);
      }
      lane_sum(X, ge, P_GE, X.ys, Y, T);
      const float eps_new = max0(eps - tau * (-ge[0] + cs_eps));
      const float eb = 2.f * eps_new - eps;
      // primal step over the block's columns: the gathers one warp per
      // column into pbs (free until p-bar is staged), then the update one
      // thread per column, so the column state's loads overlap
      for (int cl = warp; cl < nc; cl += kWarps) {
        const float g = col_dot(X, cl, lane);
        if (lane == 0) X.pbs[cl] = g;
      }
      __syncthreads();
      float rq[1] = {0.f};
      for (int cl = tid; cl < nc; cl += kThreads) {
        const float a = arow[cl];
        const float pc = P[cl];
        const float pn = max0(pc - tau * (X.pbs[cl] + mu * a));
        const float pbv = 2.f * pn - pc;
        P[cl] = pn;
        PS[cl] += pn;
        PB[c0 + cl] = pbv;
        rq[0] += a * pbv;
      }
      lane_sum(X, rq, P_RQ, X.pbs, PB, Cp);
      const float mu_new = mu + sigma * (rq[0] - bs);
      // forward product and dual step over the block's types
      forward(X, [&](int tl, float u) {
        const float ec = ecol[tl] * eb;
        const float ln = max0(llo[tl] + sigma * ((-u - ec) - hlo[tl]));
        const float un = max0(lup[tl] + sigma * ((u - ec) - hup[tl]));
        llo[tl] = ln;
        lup[tl] = un;
        lls[tl] += ln;
        lus[tl] += un;
      });
      eps = eps_new;
      es += eps_new;
      mu = mu_new;
      ms += mu_new;
      __syncthreads();
    }

    // averaged iterate blended with the carried one
    for (int cl = tid; cl < nc; cl += kThreads) AVN[cl] = (PAV[cl] + PS[cl] * inv) * 0.5f;
    for (int tl = tid; tl < nt; tl += kThreads) {
      lla[tl] = (llav[tl] + lls[tl] * inv) * 0.5f;
      lua[tl] = (luav[tl] + lus[tl] * inv) * 0.5f;
    }
    const float ea = (eav + es * inv) * 0.5f;
    const float ma = (mav + ms * inv) * 0.5f;
    __syncthreads();
    const float r_cur = kkt(X, P, eps, llo, lup, mu, bs, cs_eps, scale);
    const float r_avg = kkt(X, AVN, ea, lla, lua, ma, bs, cs_eps, scale);
    // restart to the average when it is strictly better
    if (r_avg < r_cur) {
      for (int cl = tid; cl < nc; cl += kThreads) P[cl] = AVN[cl];
      for (int tl = tid; tl < nt; tl += kThreads) {
        llo[tl] = lla[tl];
        lup[tl] = lua[tl];
      }
      eps = ea;
      mu = ma;
    }
    const float res_new = nan_min(r_cur, r_avg);
    __syncthreads();
    // primal-weight update from the block's movement norms
    float dd[2] = {0.f, 0.f};
    for (int cl = tid; cl < nc; cl += kThreads) {
      const float d = P[cl] - P0[cl];
      dd[0] += d * d;
    }
    for (int tl = tid; tl < nt; tl += kThreads) {
      const float d1 = llo[tl] - llo0[tl], d2 = lup[tl] - lup0[tl];
      dd[1] += d1 * d1 + d2 * d2;
    }
    lane_sum(X, dd, P_DD);
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
      for (int cl = tid; cl < nc; cl += kThreads) PAV[cl] = AVN[cl];
      for (int tl = tid; tl < nt; tl += kThreads) {
        llav[tl] = lla[tl];
        luav[tl] = lua[tl];
      }
      eav = ea;
      mav = ma;
      it += ce;
      res = res_new;
      omega = omega_out;
    } else {
      for (int cl = tid; cl < nc; cl += kThreads) P[cl] = P0[cl];
      for (int tl = tid; tl < nt; tl += kThreads) {
        llo[tl] = llo0[tl];
        lup[tl] = lup0[tl];
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

  if (kResident) {
    // the block's state back to the lane's outputs
    for (int i = tid; i < nc; i += kThreads) {
      gP[i] = P[i];
      gPAV[i] = PAV[i];
    }
    for (int i = tid; i < nt; i += kThreads) {
      gllo[i] = llo[i];
      glup[i] = lup[i];
      gllav[i] = llav[i];
      gluav[i] = luav[i];
    }
  }
  // every block has read the scalar row before block 0 rewrites it
  group_sync(X.bar);
  if (j == 0 && tid == 0) {
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

// `rounds` group barriers back to back, one group of nb blocks per lane: the
// barrier's own cost at a launched grid
__global__ void __launch_bounds__(kThreads) barrier_loop_kernel(unsigned long long* bar, int nb,
                                                                int rounds) {
  GroupBarrier g;
  g.count = bar + blockIdx.x / nb;
  g.target = 0;
  g.nblocks = (unsigned int)nb;
  for (int r = 0; r < rounds; ++r) group_sync(g);
}

// Shared memory one block needs at (T, Cp) with `tile_floats` of resident
// pack (0 when it streams): the fit rule of two_sided_layout.cuh, which the
// Python gate reads as well.
long long two_sided_smem_bytes(int T, int Cp, int tile_floats) {
  return ((long long)kTVectors * round_up(T, kAlignFloats) +
          (long long)kCVectors * round_up(Cp, kAlignFloats) + kRedFloats + tile_floats) *
         (long long)sizeof(float);
}

template <class K>
cudaError_t occupancy_of(K kernel, int smem, int* per_sm, int* sms) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) {
    return e;
  }
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, (size_t)smem);
}

// blocks of the solve kernel (resident or streaming) one SM holds with
// `smem` bytes of shared memory, and the SM count
cudaError_t occupancy(int smem, bool resident, int* per_sm, int* sms) {
  if (smem <= 0 || smem > kMaxSmem) return cudaErrorInvalidValue;
  return resident ? occupancy_of(two_sided_solve_kernel<true>, smem, per_sm, sms)
                  : occupancy_of(two_sided_solve_kernel<false>, smem, per_sm, sms);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers unless said
// otherwise; stream is a cudaStream_t. Each returns a cudaError_t (0 on
// success).

// out (host int[2]): blocks per SM with `smem` bytes (resident pack or
// not), SM count
extern "C" int two_sided_occupancy(int smem, int resident, void* out) {
  int* o = (int*)out;
  return (int)occupancy(smem, resident != 0, o, o + 1);
}

extern "C" int two_sided_solve_launch(
    const void* idx, const void* vals, const void* rowptr, const void* colT,
    const void* vsT, const void* ecol, const void* hlo, const void* hup,
    const void* arow, void* p, void* pav, void* llo, void* lup, void* llav,
    void* luav, void* scal, void* iters, void* scratch, void* bar, const void* plan,
    int B, int T, int Cp, int kp, int nnz, int nb, int tile_floats, int check_every,
    int max_iters, int sentinel, void* stream) {
  if (B <= 0) return 0;
  if (nb <= 0 || check_every <= 0 || tile_floats < 0) return (int)cudaErrorInvalidValue;
  const long long smem = two_sided_smem_bytes(T, Cp, tile_floats);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool resident = tile_floats > 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = occupancy((int)smem, resident, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  // every block of every lane must be resident at once, or a barrier waits
  // for a block that never runs
  if ((long long)B * nb > (long long)per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params prm;
  prm.idx = (const int*)idx;
  prm.vals = (const float*)vals;
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
  prm.scratch = (float*)scratch;
  prm.bar = (unsigned long long*)bar;
  prm.plan = (const int*)plan;
  prm.T = T;
  prm.Cp = Cp;
  prm.kp = kp;
  prm.nnz = nnz;
  prm.nb = nb;
  prm.tile_floats = tile_floats;
  prm.check_every = check_every;
  prm.max_iters = max_iters;
  prm.sentinel = sentinel;
  void* args[] = {&prm};
  const void* fn = resident ? (const void*)two_sided_solve_kernel<true>
                            : (const void*)two_sided_solve_kernel<false>;
  e = cudaLaunchCooperativeKernel(fn, dim3(B * nb), dim3(kThreads), args, (size_t)smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// `rounds` barriers over `groups` groups of nb blocks; bar is int64 [groups], zero
extern "C" int two_sided_barrier_loop(void* bar, int groups, int nb, int rounds, void* stream) {
  if (groups <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  unsigned long long* b = (unsigned long long*)bar;
  void* args[] = {&b, &nb, &rounds};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)barrier_loop_kernel,
                                              dim3(groups * nb), dim3(kThreads), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
