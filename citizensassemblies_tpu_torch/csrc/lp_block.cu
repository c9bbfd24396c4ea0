// Generic-form PDHG LP for Hopper (sm_90a): the whole restarted PDHG solve of
//
//     min c'x  s.t.  G x <= h,  A x = b,  x >= 0
//
// in scaled coordinates (the wrapper equilibrates the stacked [G; A]), with
// G as packed ELL rows and A a small dense block (m2 <= kLpMaxM2 rows), in
// one cooperative launch that spreads the solve over a group of thread
// blocks.
//
// Replaces: citizensassemblies_tpu/kernels/pdhg_megakernel.py:_lp_block_kernel
// (one Pallas program computing one PDHG block of this LP: check_every
// iterations, the KKT of the current and the averaged iterate, restart to
// the better one, the omega rebalance, the sentinel freeze and the active
// mask; an XLA while_loop around it launched one block at a time). Here the
// loop over blocks runs inside the kernel too, so a solve is one launch with
// no host synchronisation between blocks.
//
// What bounds it on the H100. Every iteration reads the whole pack, in two
// layouts (row-major [m1, kp] for G x, a variable-major CSR for G^T lam):
// about 7.3 MB at the flagship dual LP (m1 = 4096 panel rows, kp = 112,
// nv = 1728), for about four flops per 8 bytes, served from the 50 MB L2.
// The first port ran the solve in one block and so pulled that through one
// SM's share of L2 bandwidth (~61 GB/s, 118 us an iteration). Spread over
// all 132 SMs with each block's share resident in shared memory, an
// iteration moves only the staged lambda and x-bar and is bound by the
// latency of its chain (chip_smoke.py, chip_lp_probe.py, PERF.md): two
// group barriers of about 1 us each, two L2 round trips to stage, and each
// block's passes over its own rows and variables, about 6.6 us in all at
// the flagship. A small LP cannot use the card: across blocks it pays the
// same exchanges (about 5.4 us an iteration at a sf_b dual), so up to a
// size it runs on one block, which exchanges nothing through global
// memory and is bound by its serial passes.
//
// Design (the two-sided kernel's, over rows and variables):
//  * the launch plan (blocks, each block's contiguous row tile and variable
//    tile, the variables balanced by their CSR entries; a small LP takes
//    fewer blocks, down to one) is computed on the host from this file's
//    layout header, the SM count and the occupancy that lp_occupancy
//    reports, and passed in;
//  * a block owns its rows (G x-bar, the dual step, lambda, its average,
//    running sum and block-start copy, h) and its variables (G^T lam,
//    A^T mu, the primal step, x and its four companions, c and its columns
//    of A);
//  * a row, and a variable, take a group of lanes sized so that the tile's
//    rows, and variables, take one pass over the block's threads; a block
//    with rows for half its threads or more takes them one lane each over
//    a slot-major copy. A variable of a tile with fewer variables than lane
//    groups gets several groups, its parts added in part order (the dual
//    LP's y-hat, in every row, gets a tile of its own at the flagship); a
//    variable whose run is over four times its tile's mean (y-hat in a
//    small LP's one block) takes a pass over all the threads of its block;
//  * mu (m2 floats) is held by every block and stepped identically from the
//    group-summed A x-bar;
//  * a block keeps its share of the pack (its rows of the pack, its
//    variables' run of the CSR) and its state resident in shared memory
//    for the whole solve when the plan says it fits, else it streams that
//    share from L2 and keeps its state in global memory;
//  * x-bar takes one of two routes, a template flag the plan sets
//    (stage_x): where all of it fits a block's shared memory beside the
//    staged lambda, every block stages it there after each barrier, as
//    below; past that (the nationwide dual LP's 100,001 variables) a block
//    keeps neither x-bar nor a CSR row pointer in shared memory: it reads
//    its variables' row pointer from the read-only global one, and its
//    rows read x-bar from the global vector the variable owners publish,
//    through the L2 (ld.global.cg, never the read-only path: x-bar is
//    written inside the launch), at the pack's indices only. Every sum
//    keeps its order, so the two routes agree bit for bit wherever both
//    run;
//  * an iteration: variable owners take the primal step from the staged
//    lambda and publish their x-bar tile and their partial A x-bar; group
//    barrier; every block sums the partials in block order and steps mu
//    while staging x-bar; row owners take the dual step and publish their
//    lambda tile; group barrier; every block stages lambda. A solve on one
//    block publishes straight into its staged vectors (x-bar into its
//    global vector on the global route), with a __syncthreads for each
//    barrier;
//  * scalar sums (A x-bar, the KKT terms, the movement norms) are warp sums
//    added in warp order into a [slots, blocks] scratch and, after the
//    barrier, summed by every block in block order (grid_sync.cuh): every
//    block holds bitwise the same scalars and takes the same decisions
//    (loop, restart, sentinel, stall), and the iteration count is a
//    property of the inputs. No float atomics.
// All sums are float32 in a fixed order; min/max/clip propagate NaN as jnp
// does, and padding slots keep 0 * x[0], so a poisoned solve is detected and
// quarantined as in the reference.

#include "grid_sync.cuh"
#include "lp_layout.cuh"

namespace {

constexpr int kWarps = kLpThreads / 32;
constexpr int kStallBlocks = 64;  // mirrors lp_pdhg._STALL_BLOCKS
// the KKT's partial sums: max(Gx - h, 0)^2, lam * h, min(grad, 0)^2, c * x,
// then the m2 rows of A x
constexpr int kKkt = 4 + kLpMaxM2;
// partial-sum slots: the rows of A x-bar, the KKT terms, the two movement
// norms
constexpr int P_AX = 0;
constexpr int P_KKT = kLpMaxM2;
constexpr int P_DD = P_KKT + kKkt;
static_assert(P_DD + 2 == kLpSlots, "slots and layout header disagree");
// lanes a variable's gather takes at least (so at most kLpThreads / 4
// lane groups), and a row's at most
constexpr int kMinVarLanes = 4;
constexpr int kMaxRowLanes = 16;
// variables of a block that take a pass over all its threads at most
constexpr int kMaxHeavy = 7;
// slices of the reduction scratch: the warps' partial sums, group_sum,
// split parts, the heavy variables (a count and up to kMaxHeavy indices)
constexpr int kGroupRed = kKkt * kWarps;
constexpr int kPartRed = kGroupRed + 16;
constexpr int kHeavyRed = kPartRed + kLpThreads / kMinVarLanes;
static_assert(kHeavyRed + 1 + kMaxHeavy <= kLpRedFloats, "reduction scratch too small");

struct Params {
  const int* idx;      // [m1, kp] row-major pack
  const float* vals;   // [m1, kp] scaled values
  const int* rowptr;   // [nv + 1] variable-major transpose
  const int* rowT;     // [nnz] row of each entry
  const float* vsT;    // [nnz]
  const float* As;     // [m2, nv] scaled equality block
  const float* cs;     // [nv]
  const float* hs;     // [m1]
  const float* bs;     // [m2]
  float* x;            // [nv] state in/out
  float* xav;
  float* lam;          // [m1] state in/out
  float* lav;
  float* mu;           // [m2] state in/out
  float* mav;
  float* scal;         // [L_N]
  int* iters;          // [1]
  float* scratch;      // lp_layout.cuh
  unsigned long long* bar;  // [1], zero
  const int* plan;     // [2 * (nb + 1)]: row bounds, then variable bounds
  int nv, m1, m2, kp, nb, tile_floats, check_every, max_iters, sentinel;
};

__host__ __device__ __forceinline__ int round_up(int n, int m) { return (n + m - 1) / m * m; }

// floats of shared memory a resident block needs beyond the staged vectors:
// its share of both pack layouts and its row and variable state
__host__ __device__ __forceinline__ int resident_floats(int nr, int nvt, int ne, int kp, int m2) {
  return 2 * (nr * kp + ne) + kLpOwnRowVectors * nr + (kLpOwnVarVectors + m2) * nvt;
}

// one block's view of the solve. Everything it owns is indexed locally:
// row r = r0 + rl, variable v = v0 + vl; slot s of its row rl at
// rl * rstride + s * sstride of tidx/tval (row-major, or slot-major when a
// row takes one lane) and, for CSR entry e, at e - e0 of tcol/tvs; its
// columns of A at r * astride + vl of A.
struct Ctx {
  const int* tidx;
  const float* tval;
  // [nvt + 1] the block's CSR row pointer: staged less e0, or the global
  // one from the block's first variable on (row_start)
  const int* trp;
  const int* tcol;
  const float* tvs;
  const float* h;  // [nr]
  const float* c;  // [nvt]
  const float* A;
  int astride, rstride, sstride;
  float* XK;    // the KKT's published x (global, all nv; xbs on one staged block)
  float* LK;    // the KKT's published lambda (global, all m1; lams on one block)
  float* part;  // [kLpSlots, nb]
  float* lams;  // shared [m1]: staged lambda
  float* xbs;   // shared [nv]: staged x-bar (null on the global route)
  float* red;   // shared [kLpRedFloats]
  const float* bs;  // shared [kLpMaxM2]
  const int* heavy;  // shared: count, then local indices
  GroupBarrier bar;
  int nv, m1, m2, kp, nb, j, r0, nr, v0, nvt, e0, rg, vg;
};

// (A^T mu) for the block's local variable vl
__device__ __forceinline__ float at_dot(const Ctx& X, int vl, const float* mu) {
  float a = 0.f;
  for (int r = 0; r < X.m2; ++r) a += X.A[r * X.astride + vl] * mu[r];
  return a;
}

// ell_dot with y read through the L2 (__ldcg): y is an x-bar that blocks of
// this launch publish, so it must not come through the non-coherent
// read-only path, which ell_dot's restrict-qualified y may take. The same
// slots in the same order, so the same sum bit for bit.
__device__ __forceinline__ float ell_dot_cg(const int* __restrict__ idx,
                                            const float* __restrict__ val,
                                            int begin, int step, int kp,
                                            long long stride, const float* y) {
  float acc = 0.f;
#pragma unroll 4
  for (int s = begin; s < kp; s += step) {
    const long long o = (long long)s * stride;
    acc += val[o] * __ldcg(y + idx[o]);
  }
  return acc;
}

// f(rl, u) with u = (G y)[r0 + rl] over the row-major pack for each of the
// block's rows, on one thread: a row takes a group of X.rg lanes and the
// group's lane sums are added by the xor butterfly. y is the staged x-bar
// in shared memory (kStageX) or the published one in global memory.
template <bool kStageX, class F>
__device__ __forceinline__ void rows_apply(const Ctx& X, const float* y, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = X.rg, per_warp = 32 / rg;
  const int sub = lane / rg, sl = lane % rg;
  for (int base = warp * per_warp; base < X.nr; base += kWarps * per_warp) {
    const int rl = base + sub;
    float u = 0.f;
    if (rl < X.nr) {
      const long long o = (long long)rl * X.rstride;
      if constexpr (kStageX) {
        u = ell_dot(X.tidx + o, X.tval + o, sl, rg, X.kp, X.sstride, y);
      } else {
        u = ell_dot_cg(X.tidx + o, X.tval + o, sl, rg, X.kp, X.sstride, y);
      }
    }
    for (int off = rg >> 1; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
    if (sl == 0 && rl < X.nr) f(rl, u);
  }
}

// the block's first CSR entry of local variable vl, less e0: from the
// staged row pointer, or from the global one on the global-x-bar route
template <bool kStageX>
__device__ __forceinline__ int row_start(const Ctx& X, int vl) {
  if constexpr (kStageX) {
    return X.trp[vl];
  } else {
    return __ldg(X.trp + vl) - X.e0;
  }
}

// g = (G^T y)[v0 + vl] over the CSR for the block's variables; f(vl, g)
// runs once per local variable on one thread. A variable takes a group of
// X.vg lanes; when the tile has fewer variables than the block has groups
// (the dual LP's y-hat, in every row, in a tile of its own or nearly), a
// variable gets groups / nvt consecutive groups, and their part sums are
// added in part order. Otherwise the block's heavy variables (X.heavy: a
// CSR run of more than four times the tile's mean, such as y-hat beside
// the agents of a small LP on one block) are left out of that pass and
// take one pass each over all the block's threads afterwards, summed by
// the xor butterfly in each warp and the warps' sums in warp order.
template <bool kStageX, class F>
__device__ __forceinline__ void gt_apply(const Ctx& X, const float* y, F f) {
  const int nt = X.nvt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int vg = X.vg, per_warp = 32 / vg, groups = kWarps * per_warp;
  const int sub = lane / vg, sl = lane % vg;
  const int parts = (nt == 0 || nt >= groups) ? 1 : groups / nt;
  const int jobs = nt * parts;
  const int nheavy = parts == 1 ? X.heavy[0] : 0;
  float* tpart = X.red + kPartRed;
  for (int base = warp * per_warp; base < jobs; base += groups) {
    const int job = base + sub;
    const int vl = job / parts, q = job % parts;
    bool mine = job < jobs;
    for (int h = 0; h < nheavy; ++h) mine = mine && X.heavy[1 + h] != vl;
    float g = 0.f;
    if (mine) {
      const int e1 = row_start<kStageX>(X, vl + 1);
#pragma unroll 4
      for (int e = row_start<kStageX>(X, vl) + q * vg + sl; e < e1; e += parts * vg) {
        g += X.tvs[e] * y[X.tcol[e]];
      }
    }
    for (int off = vg >> 1; off > 0; off >>= 1) g += __shfl_xor_sync(0xffffffffu, g, off);
    if (sl == 0 && mine) {
      if (parts == 1) {
        f(vl, g);
      } else {
        tpart[job] = g;
      }
    }
  }
  if (parts > 1) {
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      float g = 0.f;
      for (int q = 0; q < parts; ++q) g += tpart[threadIdx.x * parts + q];
      f((int)threadIdx.x, g);
    }
    __syncthreads();
  }
  for (int h = 0; h < nheavy; ++h) {
    const int vl = X.heavy[1 + h];
    const int e1 = row_start<kStageX>(X, vl + 1);
    float g = 0.f;
#pragma unroll 4
    for (int e = row_start<kStageX>(X, vl) + (int)threadIdx.x; e < e1; e += kLpThreads) {
      g += X.tvs[e] * y[X.tcol[e]];
    }
    g = warp_sum(g);
    if (lane == 0) tpart[warp] = g;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += tpart[w];
      f(vl, t);
    }
    if (h + 1 < nheavy) __syncthreads();  // tpart is written again
  }
}

// the solve's totals of v[0..rows) (rows <= N): each warp's sums go to
// shared memory, then, after one __syncthreads, thread 0 adds the warps' in
// warp order into this block's partials at `slot` and, after the group
// barrier, every block adds the blocks' in block order (group_sum, which
// meanwhile stages n floats src -> dst). A solve of one block has no
// partials: every thread adds the warps' sums itself. The warps' sums stay
// in red until the caller's next __syncthreads.
template <int N>
__device__ __forceinline__ void solve_sum(Ctx& X, float (&v)[N], int slot, int rows,
                                          float* dst = nullptr, const float* src = nullptr,
                                          int n = 0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < rows) {
      const float w = warp_sum(v[i]);
      if (lane == 0) X.red[i * kWarps + warp] = w;
    }
  }
  __syncthreads();  // also orders every thread's global writes before the barrier
  if (X.nb == 1 || threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < rows) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += X.red[i * kWarps + w];
        v[i] = t;
        if (X.nb > 1) X.part[(slot + i) * X.nb + X.j] = t;
      }
    }
  }
  if (X.nb == 1) return;  // the block's sums are the totals; nothing to stage
  group_sync(X.bar, true);
  group_sum<N, kLpThreads>(X.part + slot * X.nb, X.nb, v, X.red + kGroupRed, dst, src, n, rows);
}

// combined relative KKT residual at (x, lam, mu): x over the block's
// variables, lam over its rows (local views), mu in shared memory; the
// rows read the published x staged (kStageX) or where it was published
template <bool kStageX>
__device__ float kkt(Ctx& X, const float* x, const float* lam, const float* mu, float scale) {
  const int tid = threadIdx.x;
  const int m2 = X.m2;
  float k[kKkt];
#pragma unroll
  for (int i = 0; i < kKkt; ++i) k[i] = 0.f;
  // publish x and lam; the terms the block takes from its own tiles
  for (int vl = tid; vl < X.nvt; vl += kLpThreads) {
    const float xv = x[vl];
    X.XK[X.v0 + vl] = xv;
    k[3] += X.c[vl] * xv;
#pragma unroll
    for (int r = 0; r < kLpMaxM2; ++r) {
      if (r < m2) k[4 + r] += X.A[r * X.astride + vl] * xv;
    }
  }
  for (int rl = tid; rl < X.nr; rl += kLpThreads) {
    const float l = lam[rl];
    X.LK[X.r0 + rl] = l;
    k[1] += l * X.h[rl];
  }
  group_sync(X.bar);
  if (X.nb > 1) {
    if (kStageX) stage_floats(X.xbs, X.XK, round_up(X.nv, kLpAlignFloats), 0, kLpThreads);
    stage_floats(X.lams, X.LK, round_up(X.m1, kLpAlignFloats), 0, kLpThreads);
    __syncthreads();
  }
  // G x over the block's rows, G^T lam over its variables
  rows_apply<kStageX>(X, kStageX ? X.xbs : X.XK, [&](int rl, float u) {
    const float r = max0(u - X.h[rl]);
    k[0] += r * r;
  });
  gt_apply<kStageX>(X, X.lams, [&](int vl, float g) {
    const float m = min0((X.c[vl] + g) + at_dot(X, vl, mu));
    k[2] += m * m;
  });
  solve_sum(X, k, P_KKT, 4 + m2);
  float eq2 = 0.f, mub = 0.f;
#pragma unroll
  for (int r = 0; r < kLpMaxM2; ++r) {
    if (r < m2) {
      const float d = k[4 + r] - X.bs[r];
      eq2 += d * d;
      mub += mu[r] * X.bs[r];
    }
  }
  const float pri = sqrtf(k[0] + eq2);
  const float dua = sqrtf(k[2]);
  const float pobj = k[3];
  const float dobj = -k[1] - mub;
  const float gap = fabsf(pobj - dobj);
  return (pri + dua) / scale + gap / (1.f + fabsf(pobj) + fabsf(dobj));
}

template <bool kResident, bool kStageX>
__global__ void __launch_bounds__(kLpThreads) lp_solve_kernel(Params prm) {
  extern __shared__ __align__(16) float sm[];
  const int nv = prm.nv, m1 = prm.m1, m2 = prm.m2, kp = prm.kp, nb = prm.nb;
  const int nv4 = round_up(nv, kLpAlignFloats), m14 = round_up(m1, kLpAlignFloats);
  const int nvp = round_up(nv + 1, kLpAlignFloats);
  const int j = blockIdx.x;
  const int tid = threadIdx.x;

  Ctx X;
  X.r0 = prm.plan[j];
  X.nr = prm.plan[j + 1] - X.r0;
  X.v0 = prm.plan[nb + 1 + j];
  X.nvt = prm.plan[nb + 2 + j] - X.v0;
  X.e0 = prm.rowptr[X.v0];
  const int r0 = X.r0, nr = X.nr, v0 = X.v0, nvt = X.nvt;
  const int ne = prm.rowptr[v0 + nvt] - X.e0;
  X.lams = sm;
  // the block's CSR row pointer, relative to its first entry, after the
  // staged x-bar; on the global route neither is in shared memory
  const int* trp;
  if (kStageX) {
    X.xbs = sm + m14;
    int* srp = reinterpret_cast<int*>(X.xbs + nvp);
    for (int i = tid; i <= nvt; i += kLpThreads) srp[i] = prm.rowptr[v0 + i] - X.e0;
    trp = srp;
    X.red = reinterpret_cast<float*>(srp + nvp);
  } else {
    X.xbs = nullptr;
    trp = prm.rowptr + v0;
    X.red = sm + m14;
  }
  X.trp = trp;
  // mu and its companions, the same bits in every block
  float* mu = X.red + kLpRedFloats;
  float* mu0 = mu + kLpMaxM2;
  float* mav = mu0 + kLpMaxM2;
  float* ms = mav + kLpMaxM2;
  float* ma = ms + kLpMaxM2;
  float* bsv = ma + kLpMaxM2;
  X.bs = bsv;
  // lane groups: a row, and a variable, take as many lanes (up to
  // kMaxRowLanes, and 32) as leave all of the tile's rows, and variables,
  // one pass over the block's threads; a resident block with rows for at
  // least half its threads takes them one lane each, over a slot-major
  // copy (conflict-free reads, every lane updating its own row)
  int rg = kMaxRowLanes;
  while (rg > 1 && rg * nr > kLpThreads) rg >>= 1;
  if (kResident && rg <= 2) rg = 1;
  X.rg = rg;
  X.rstride = kResident && rg == 1 ? 1 : kp;
  X.sstride = kResident && rg == 1 ? nr : 1;
  int vg = 32;
  while (vg > kMinVarLanes && vg * nvt > kLpThreads) vg >>= 1;
  X.vg = vg;
  // the heavy variables (gt_apply)
  int* heavy = reinterpret_cast<int*>(X.red + kHeavyRed);
  __syncthreads();  // the staged row pointer is written
  if (tid == 0) {
    int n = 0;
    for (int vl = 0; vl < nvt && nvt > 1 && n < kMaxHeavy; ++vl) {
      if ((long long)(trp[vl + 1] - trp[vl]) * nvt > 4LL * ne) heavy[1 + n++] = vl;
    }
    heavy[0] = n;
  }
  X.heavy = heavy;
  // global scratch: the published vectors, a streaming block's state, the
  // partials. A solve of one block publishes straight into its staged
  // vectors: nothing has to go through global memory but, on the global
  // route, x-bar (its rows read it after a __syncthreads).
  float* gXB = prm.scratch;
  float* gXK = gXB + nv4;
  float* gLB = gXK + 4 * nv4;
  float* gLK = gLB + m14;
  X.part = gLK + 4 * m14;
  float* XB = nb == 1 && kStageX ? X.xbs : gXB;
  float* LB = nb == 1 ? X.lams : gLB;
  X.XK = nb == 1 && kStageX ? X.xbs : gXK;
  X.LK = nb == 1 ? X.lams : gLK;
  // the block's own slices of the inputs and of the state
  float* gx = prm.x + v0;
  float* gxav = prm.xav + v0;
  float* glam = prm.lam + r0;
  float* glav = prm.lav + r0;
  const int* gidx = prm.idx + (long long)r0 * kp;
  const float* gval = prm.vals + (long long)r0 * kp;
  const int* gcol = prm.rowT + X.e0;
  const float* gvs = prm.vsT + X.e0;
  float *x, *xav, *x0, *xs, *xa, *c;
  float *lam, *lav, *lam0, *ls, *la, *h;
  if (kResident) {
    // the block's share of the pack and its own state, in shared memory
    // for the whole solve
    if (resident_floats(nr, nvt, ne, kp, m2) > prm.tile_floats) __trap();  // the plan is wrong
    int* sidx = reinterpret_cast<int*>(bsv + kLpMaxM2);
    float* sval = reinterpret_cast<float*>(sidx + nr * kp);
    int* scol = reinterpret_cast<int*>(sval + nr * kp);
    float* svs = reinterpret_cast<float*>(scol + ne);
    lam = svs + ne;
    lav = lam + nr;
    lam0 = lav + nr;
    ls = lam0 + nr;
    la = ls + nr;
    h = la + nr;
    x = h + nr;
    xav = x + nvt;
    x0 = xav + nvt;
    xs = x0 + nvt;
    xa = xs + nvt;
    c = xa + nvt;
    float* sA = c + nvt;  // [m2, nvt]
    for (int i = tid; i < nr * kp; i += kLpThreads) {
      const int o = (i / kp) * X.rstride + (i % kp) * X.sstride;
      sidx[o] = __ldg(gidx + i);
      sval[o] = __ldg(gval + i);
    }
    for (int i = tid; i < ne; i += kLpThreads) {
      scol[i] = __ldg(gcol + i);
      svs[i] = __ldg(gvs + i);
    }
    for (int i = tid; i < nr; i += kLpThreads) {
      lam[i] = glam[i];
      lav[i] = glav[i];
      h[i] = prm.hs[r0 + i];
    }
    for (int i = tid; i < nvt; i += kLpThreads) {
      x[i] = gx[i];
      xav[i] = gxav[i];
      c[i] = prm.cs[v0 + i];
    }
    for (int i = tid; i < m2 * nvt; i += kLpThreads) {
      sA[i] = prm.As[(long long)(i / nvt) * nv + v0 + i % nvt];
    }
    X.tidx = sidx;
    X.tval = sval;
    X.tcol = scol;
    X.tvs = svs;
    X.A = sA;
    X.astride = nvt;
  } else {
    X.tidx = gidx;
    X.tval = gval;
    X.tcol = gcol;
    X.tvs = gvs;
    X.A = prm.As + v0;
    X.astride = nv;
    x = gx;
    xav = gxav;
    x0 = gXK + nv4 + v0;
    xs = x0 + nv4;
    xa = xs + nv4;
    c = const_cast<float*>(prm.cs) + v0;
    lam = glam;
    lav = glav;
    lam0 = gLK + m14 + r0;
    ls = lam0 + m14;
    la = ls + m14;
    h = const_cast<float*>(prm.hs) + r0;
  }
  X.h = h;
  X.c = c;
  for (int r = tid; r < m2; r += kLpThreads) {
    mu[r] = prm.mu[r];
    mav[r] = prm.mav[r];
    bsv[r] = prm.bs[r];
  }
  // lambda as the launch found it (written by the host before the launch,
  // so no barrier is needed before reading it)
  stage_floats(X.lams, prm.lam, m1, 0, kLpThreads);
  X.bar.count = prm.bar;
  X.bar.target = 0;
  X.bar.nblocks = (unsigned int)nb;
  X.nv = nv;
  X.m1 = m1;
  X.m2 = m2;
  X.kp = kp;
  X.nb = nb;
  X.j = j;

  const float* sc = prm.scal;
  float res = sc[L_RES], omega = sc[L_OMEGA], pois = sc[L_POIS];
  float stall = sc[L_STALL], best = sc[L_BEST], since = sc[L_SINCE];
  const float norm = sc[L_NORM], scale = sc[L_SCALE], tol = sc[L_TOL];
  int it = prm.iters[0];
  const int ce = prm.check_every;
  const float inv = 1.0f / (float)ce;
  __syncthreads();

  // the active mask (a NaN residual compares false, so a poisoned solve
  // without the sentinel stops here too); every block holds the same
  // scalars, so all of them leave the loop together
  while (res > tol && it < prm.max_iters && pois == 0.f) {
    const float tau = 0.9f * omega / norm;
    const float sigma = 0.9f / (omega * norm);
    for (int vl = tid; vl < nvt; vl += kLpThreads) {
      x0[vl] = x[vl];
      xs[vl] = 0.f;
    }
    for (int rl = tid; rl < nr; rl += kLpThreads) {
      lam0[rl] = lam[rl];
      ls[rl] = 0.f;
    }
    if (tid == 0) {
      for (int r = 0; r < m2; ++r) {
        mu0[r] = mu[r];
        ms[r] = 0.f;
      }
    }
    __syncthreads();

    for (int k = 0; k < ce; ++k) {
      // primal step over the block's variables from the staged lambda;
      // x-bar published for every block, A x-bar summed over them
      float ax[kLpMaxM2];
#pragma unroll
      for (int r = 0; r < kLpMaxM2; ++r) ax[r] = 0.f;
      gt_apply<kStageX>(X, X.lams, [&](int vl, float g) {
        const float grad = (c[vl] + g) + at_dot(X, vl, mu);
        const float xo = x[vl];
        const float xn = max0(xo - tau * grad);
        const float xb = 2.f * xn - xo;
        x[vl] = xn;
        xs[vl] += xn;
        XB[v0 + vl] = xb;
#pragma unroll
        for (int r = 0; r < kLpMaxM2; ++r) {
          if (r < m2) ax[r] += X.A[r * X.astride + vl] * xb;
        }
      });
      if (kStageX) {
        solve_sum(X, ax, P_AX, m2, X.xbs, XB, nv4);
      } else {
        solve_sum(X, ax, P_AX, m2);
      }
      // the mu step, the same in every block (mu is next read after the
      // barrier that closes this iteration)
      if (tid == 0) {
        for (int r = 0; r < m2; ++r) {
          const float mn = mu[r] + sigma * (ax[r] - bsv[r]);
          mu[r] = mn;
          ms[r] += mn;
        }
      }
      // dual step over the block's rows from the staged x-bar, or from the
      // published one
      rows_apply<kStageX>(X, kStageX ? X.xbs : XB, [&](int rl, float u) {
        const float ln = max0(lam[rl] + sigma * (u - h[rl]));
        lam[rl] = ln;
        ls[rl] += ln;
        LB[r0 + rl] = ln;
      });
      group_sync(X.bar);
      if (nb > 1) {
        stage_floats(X.lams, LB, m14, 0, kLpThreads);
        __syncthreads();
      }
    }

    // averaged iterate blended with the carried one
    for (int vl = tid; vl < nvt; vl += kLpThreads) xa[vl] = (xav[vl] + xs[vl] * inv) * 0.5f;
    for (int rl = tid; rl < nr; rl += kLpThreads) la[rl] = (lav[rl] + ls[rl] * inv) * 0.5f;
    if (tid == 0) {
      for (int r = 0; r < m2; ++r) ma[r] = (mav[r] + ms[r] * inv) * 0.5f;
    }
    __syncthreads();
    const float r_cur = kkt<kStageX>(X, x, lam, mu, scale);
    const float r_avg = kkt<kStageX>(X, xa, la, ma, scale);
    const bool restart = r_avg < r_cur;
    const float res_new = nan_min(r_cur, r_avg);
    // sentinel: a non-finite residual reverts the whole carry to the block
    // start and quarantines the solve
    const bool ok = !prm.sentinel || isfinite(res_new);
    __syncthreads();  // every thread has read mu in the KKT
    // restart to the average when it is strictly better
    if (restart) {
      for (int vl = tid; vl < nvt; vl += kLpThreads) x[vl] = xa[vl];
      for (int rl = tid; rl < nr; rl += kLpThreads) lam[rl] = la[rl];
      if (tid == 0) {
        for (int r = 0; r < m2; ++r) mu[r] = ma[r];
      }
    }
    __syncthreads();
    // primal-weight update from the block's movement norms; lambda as the
    // next block starts it is published and staged meanwhile
    float dmu2 = 0.f;
    for (int r = 0; r < m2; ++r) {
      const float d = mu[r] - mu0[r];
      dmu2 += d * d;
    }
    float dd[2] = {0.f, 0.f};
    for (int vl = tid; vl < nvt; vl += kLpThreads) {
      const float d = x[vl] - x0[vl];
      dd[0] += d * d;
    }
    for (int rl = tid; rl < nr; rl += kLpThreads) {
      const float d = lam[rl] - lam0[rl];
      dd[1] += d * d;
      LB[r0 + rl] = ok ? lam[rl] : lam0[rl];
    }
    solve_sum(X, dd, P_DD, 2, X.lams, LB, m14);
    const float dx = sqrtf(dd[0]);
    const float dy = sqrtf(dd[1] + dmu2);
    const bool moved = (dx > 1e-12f) && (dy > 1e-12f);
    const float omega_new =
        sqrtf(omega * clipf(dy / nan_max(dx, 1e-12f), 1e-4f, 1e4f));
    const float omega_out = moved ? clipf(omega_new, 1.f / 64.f, 64.f) : omega;

    if (ok) {
      for (int vl = tid; vl < nvt; vl += kLpThreads) xav[vl] = xa[vl];
      for (int rl = tid; rl < nr; rl += kLpThreads) lav[rl] = la[rl];
      if (tid == 0) {
        for (int r = 0; r < m2; ++r) mav[r] = ma[r];
      }
      it += ce;
      res = res_new;
      omega = omega_out;
    } else {
      for (int vl = tid; vl < nvt; vl += kLpThreads) x[vl] = x0[vl];
      for (int rl = tid; rl < nr; rl += kLpThreads) lam[rl] = lam0[rl];
      if (tid == 0) {
        for (int r = 0; r < m2; ++r) mu[r] = mu0[r];
      }
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

  if (kResident) {
    // the block's state back to the outputs
    for (int i = tid; i < nvt; i += kLpThreads) {
      gx[i] = x[i];
      gxav[i] = xav[i];
    }
    for (int i = tid; i < nr; i += kLpThreads) {
      glam[i] = lam[i];
      glav[i] = lav[i];
    }
  }
  // every block has read the scalar row before block 0 rewrites it
  group_sync(X.bar);
  if (j == 0 && tid == 0) {
    for (int r = 0; r < m2; ++r) {
      prm.mu[r] = mu[r];
      prm.mav[r] = mav[r];
    }
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

// Shared memory one block needs at (nv, m1) with `tile_floats` of resident
// pack and state (0 when it streams) on x-bar's route: the fit rule of
// lp_layout.cuh, which the Python gate reads as well.
long long lp_smem_bytes(int nv, int m1, int tile_floats, bool stage_x) {
  const long long xv = stage_x ? (long long)kLpNvVectors * round_up(nv + 1, kLpAlignFloats) : 0;
  return ((long long)kLpM1Vectors * round_up(m1, kLpAlignFloats) + xv + kLpRedFloats +
          kLpM2Vectors * kLpMaxM2 + tile_floats) *
         (long long)sizeof(float);
}

}  // namespace

#ifdef LP_BLOCK_GLOBAL_X_UNIT

// lp_block_global_x.cu compiles this file a second time for the solve
// kernel's global-x-bar instances alone, so that they build in a process
// of their own beside the staged ones; the launch code below reaches them
// through this function
extern "C" const void* lp_global_x_kernel(int resident) {
  return resident ? (const void*)lp_solve_kernel<true, false>
                  : (const void*)lp_solve_kernel<false, false>;
}

#else

extern "C" const void* lp_global_x_kernel(int resident);

namespace {

// the solve kernel of a resident share or not, on x-bar's route
const void* solve_kernel(bool resident, bool stage_x) {
  if (!stage_x) return lp_global_x_kernel(resident ? 1 : 0);
  return resident ? (const void*)lp_solve_kernel<true, true>
                  : (const void*)lp_solve_kernel<false, true>;
}

cudaError_t occupancy_of(const void* kernel, int smem, int* per_sm, int* sms) {
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
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kLpThreads, (size_t)smem);
}

// blocks of the solve kernel (resident or streaming, on x-bar's route) one
// SM holds with `smem` bytes of shared memory, and the SM count
cudaError_t occupancy(int smem, bool resident, bool stage_x, int* per_sm, int* sms) {
  if (smem <= 0 || smem > kLpMaxSmem) return cudaErrorInvalidValue;
  return occupancy_of(solve_kernel(resident, stage_x), smem, per_sm, sms);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers unless said
// otherwise; stream is a cudaStream_t. Each returns a cudaError_t (0 on
// success).

// out (host int[2]): blocks per SM with `smem` bytes (resident share or
// not; x-bar staged or global), SM count
extern "C" int lp_occupancy(int smem, int resident, int stage_x, void* out) {
  int* o = (int*)out;
  return (int)occupancy(smem, resident != 0, stage_x != 0, o, o + 1);
}

// stage_x: 1 stages x-bar in every block's shared memory, 0 has rows read
// it from global memory

extern "C" int lp_solve_launch(
    const void* idx, const void* vals, const void* rowptr, const void* rowT,
    const void* vsT, const void* As, const void* cs, const void* hs,
    const void* bs, void* x, void* xav, void* lam, void* lav, void* mu,
    void* mav, void* scal, void* iters, void* scratch, void* bar, const void* plan,
    int nv, int m1, int m2, int kp, int nb, int tile_floats, int check_every, int max_iters,
    int sentinel, int stage_x, void* stream) {
  if (nb <= 0 || check_every <= 0 || tile_floats < 0 || nv <= 0 || m1 < 0 || m2 < 0 ||
      m2 > kLpMaxM2 || kp <= 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = lp_smem_bytes(nv, m1, tile_floats, stage_x != 0);
  if (smem > kLpMaxSmem) return (int)cudaErrorInvalidValue;
  const bool resident = tile_floats > 0;
  int per_sm = 0, sms = 0;
  cudaError_t e = occupancy((int)smem, resident, stage_x != 0, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  // every block must be resident at once, or a barrier waits for a block
  // that never runs
  if (nb > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params prm;
  prm.idx = (const int*)idx;
  prm.vals = (const float*)vals;
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
  prm.scratch = (float*)scratch;
  prm.bar = (unsigned long long*)bar;
  prm.plan = (const int*)plan;
  prm.nv = nv;
  prm.m1 = m1;
  prm.m2 = m2;
  prm.kp = kp;
  prm.nb = nb;
  prm.tile_floats = tile_floats;
  prm.check_every = check_every;
  prm.max_iters = max_iters;
  prm.sentinel = sentinel;
  void* args[] = {&prm};
  e = cudaLaunchCooperativeKernel(solve_kernel(resident, stage_x != 0), dim3(nb),
                                  dim3(kLpThreads), args, (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#endif  // LP_BLOCK_GLOBAL_X_UNIT
