// The generic-form LP block kernel's fit rule and scalar row, defined once.
//
// lp_block.cu includes this header, and kernels/pdhg_megakernel.py reads it
// as text (every "constexpr int NAME = VALUE;" line), so the wrapper's gate
// and the kernel's own launch check agree by construction. Keep each
// constant on a line of its own in that form.
//
// Shared memory one solve needs at (nv variables, m1 inequality rows, m2
// equality rows), bytes:
//     (kNvVectors * nv + m2 * nv + kM2Vectors * m2 + kM1Vectors * m1
//      + kLpRedFloats) * 4
#pragma once

// shared memory one thread block may use on the H100 (bytes)
constexpr int kLpMaxSmem = 232448;
// nv-length float vectors in shared memory: x, its block-start copy, its
// average, running sum and blended average, the extrapolated x-bar, and c
constexpr int kNvVectors = 7;
// m2-length float vectors in shared memory: mu, its block-start copy, its
// average, running sum and blended average, and b
constexpr int kM2Vectors = 6;
// m1-length float vectors in shared memory: lam
constexpr int kM1Vectors = 1;
// float slots of the block-reduction scratch (8 rows of 33)
constexpr int kLpRedFloats = 264;

// scalar row (float32 [L_N]): the residual, the primal weight, the sentinel
// state and the solve's constants
constexpr int L_RES = 0;
constexpr int L_OMEGA = 1;
constexpr int L_POIS = 2;
constexpr int L_STALL = 3;
constexpr int L_BEST = 4;
constexpr int L_SINCE = 5;
constexpr int L_NORM = 6;
constexpr int L_SCALE = 7;
constexpr int L_TOL = 8;
constexpr int L_N = 16;
