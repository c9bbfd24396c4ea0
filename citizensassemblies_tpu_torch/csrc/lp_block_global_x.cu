// The generic-LP kernel's global-x-bar instances (lp_block.cu, x-bar read
// where the variable owners publish it): the same source compiled once more
// as a translation unit of its own, so that nvcc builds these two instances
// in one process and the staged ones and the launch code in another, at
// once. Linked with lp_block.cu into the one library; lp_block.cu reaches
// them through lp_global_x_kernel.
#define LP_BLOCK_GLOBAL_X_UNIT
#include "lp_block.cu"
