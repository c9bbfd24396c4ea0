// The two-sided block kernel's fit rule and per-lane scalar row, defined once.
//
// two_sided_block.cu includes this header, and kernels/pdhg_megakernel.py
// reads it as text (every "constexpr int NAME = VALUE;" line), so the
// wrapper's gate and the kernel's own launch check agree by construction.
// Keep each constant on a line of its own in that form.
//
// Shared memory one lane needs at (T, Cp), in bytes:
//     (kTVectors * T + Cp + kRedFloats) * 4
#pragma once

// shared memory one thread block may use on the H100 (bytes)
constexpr int kMaxSmem = 232448;
// T-length float vectors a lane keeps in shared memory
constexpr int kTVectors = 14;
// float slots of the block-reduction scratch (8 rows of 33)
constexpr int kRedFloats = 264;

// per-lane scalar row (float32 [B, S_N]): iterate scalars, averages, the
// residual, the primal weight, the sentinel state and the lane's constants
constexpr int S_EPS = 0;
constexpr int S_MU = 1;
constexpr int S_EAV = 2;
constexpr int S_MAV = 3;
constexpr int S_RES = 4;
constexpr int S_OMEGA = 5;
constexpr int S_POIS = 6;
constexpr int S_STALL = 7;
constexpr int S_BEST = 8;
constexpr int S_SINCE = 9;
constexpr int S_BS = 10;
constexpr int S_CEPS = 11;
constexpr int S_NORM = 12;
constexpr int S_TOL = 13;
constexpr int S_SCALE = 14;
constexpr int S_N = 16;
