// The two-sided block kernel's fit rule, scratch layout and per-lane scalar
// row, defined once.
//
// two_sided_block.cu includes this header, and kernels/pdhg_megakernel.py
// reads it as text (every "constexpr int NAME = VALUE;" line), so the
// wrapper's gate, its launch plan and the kernel agree by construction.
// Keep each constant on a line of its own in that form.
//
// Shared memory one block needs at (T, Cp), in bytes, with T and Cp each
// rounded up to a multiple of kAlignFloats (16-byte vector loads):
//     (kTVectors * T + kCVectors * Cp + kRedFloats + tile) * 4
// where tile is 0 when the block streams its share of the pack from L2 and
// keeps its state in global memory and, when it keeps both resident, the
// largest block's 2 * kp * columns + 2 * CSR entries (indices and values of
// both layouts) + kOwnCVectors * columns + kOwnTVectors * types. The rule is that
// it fits kMaxSmem and that the lanes' block groups (at least one block a
// lane) are co-resident on the card.
#pragma once

// shared memory one thread block may use on the H100 (bytes)
constexpr int kMaxSmem = 232448;
// threads per block
constexpr int kThreads = 512;
// staged vectors start on 16-byte boundaries
constexpr int kAlignFloats = 4;
// T-length float vectors a block stages in shared memory (the dual source y)
constexpr int kTVectors = 1;
// C-length float vectors a block stages in shared memory (the primal p-bar)
constexpr int kCVectors = 1;
// float slots of the block's reduction scratch: block_sum (8 rows of 33),
// the forward product's per-part sums (32) and the group sums (16)
constexpr int kRedFloats = 312;

// column and type state a resident block keeps in shared memory: p, its
// average, its block-start copy, its running sum, the new average and the
// equality row; the two duals, their averages, block-start copies, running
// sums and new averages, and the three data rows
constexpr int kOwnCVectors = 6;
constexpr int kOwnTVectors = 13;

// per-lane float scratch in global memory, in this order: C-length vectors
// (p0, the running sum of p, the averaged p, p-bar, the KKT's x), T-length
// vectors (lo0, up0, the running sums, the averages, y, the KKT's y), then
// the per-block partial sums [kSlots, blocks per lane]
constexpr int kScratchCVectors = 5;
constexpr int kScratchTVectors = 8;
constexpr int kSlots = 9;

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
