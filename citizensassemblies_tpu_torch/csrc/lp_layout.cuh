// The generic-LP kernel's fit rule, scratch layout and scalar row, defined
// once.
//
// lp_block.cu includes this header, and kernels/pdhg_megakernel.py reads it
// as text (every "constexpr int NAME = VALUE;" line), so the wrapper's gate,
// its launch plan and the kernel agree by construction. Keep each constant
// on a line of its own in that form.
//
// Shared memory one block needs at (nv variables, m1 inequality rows), in
// bytes, with m1 and nv + 1 each rounded up to a multiple of kLpAlignFloats
// (16-byte vector loads), on each route of x-bar:
//   staged (stage_x: every block copies all of x-bar into shared memory)
//     (kLpM1Vectors * m1 + kLpNvVectors * (nv + 1) + kLpRedFloats
//      + kLpM2Vectors * kLpMaxM2 + tile) * 4
//   global (rows read x-bar where the variable owners publish it, and the
//   block reads its CSR row pointer from global memory)
//     (kLpM1Vectors * m1 + kLpRedFloats + kLpM2Vectors * kLpMaxM2 + tile) * 4
// where tile is 0 when the block streams its share of the pack from L2 and
// keeps its state in global memory and, when it keeps both resident, the
// largest block's 2 * kp * rows + 2 * CSR entries (indices and values of
// both layouts) + kLpOwnRowVectors * rows + (kLpOwnVarVectors + m2) * vars.
// The rule is the staged route where it fits kLpMaxSmem, else the global
// route where that fits; m2 <= kLpMaxM2; and the plan's blocks are
// co-resident on the card.
#pragma once

// shared memory one thread block may use on the H100 (bytes)
constexpr int kLpMaxSmem = 232448;
// threads per block
constexpr int kLpThreads = 512;
// staged vectors start on 16-byte boundaries
constexpr int kLpAlignFloats = 4;
// m1-length float vectors a block stages in shared memory (lambda)
constexpr int kLpM1Vectors = 1;
// (nv + 1)-length vectors a block keeps in shared memory on the staged
// route: the staged x-bar, and its own variables' CSR row pointer
constexpr int kLpNvVectors = 2;
// equality rows the kernel takes at most
constexpr int kLpMaxM2 = 8;
// kLpMaxM2-length vectors every block keeps: mu, its block-start copy, its
// average, running sum and blended average, and b
constexpr int kLpM2Vectors = 6;
// float slots of the block's reduction scratch: the warps' sums of the
// KKT's 4 + kLpMaxM2 terms (kLpThreads / 32 each), the group sums (16), the
// parts of a variable split over several lane groups (kLpThreads / 4), and
// the block's heavy variables (8)
constexpr int kLpRedFloats = 344;

// row and variable state a resident block keeps in shared memory: lambda,
// its average, block-start copy, running sum and blended average, and h;
// x, its average, block-start copy, running sum and blended average, and c
// (its m2 columns of A come on top)
constexpr int kLpOwnRowVectors = 6;
constexpr int kLpOwnVarVectors = 6;

// float scratch in global memory, in this order: nv-length vectors (the
// published x-bar, the KKT's x, x0, the running sum of x, the averaged x),
// m1-length vectors (the published lambda, the KKT's lambda, lambda0, the
// running sum, the average), then the per-block partial sums [kLpSlots,
// blocks]
constexpr int kLpScratchNvVectors = 5;
constexpr int kLpScratchM1Vectors = 5;
constexpr int kLpSlots = 22;

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
