// The expert axis of the spmm kernels of bsr_spmm.cu (decode_fwd,
// bsr_tile_fwd and bsr_tile_bwd with EXP true, blockIdx.z the expert), built
// as a library of its own: bsr_spmm_experts_fwd, bsr_spmm_palette_experts_fwd
// and bsr_spmm_t_experts, called by ops.spmm_experts,
// ops.spmm_palette_experts and ops.spmm_t_experts for E stacked matrices
// (an MoE layer's experts). What the kernels compute, how they are bound
// and why is in bsr_spmm.cu; here it is only compiled apart, so that nvcc
// builds the single-matrix and the expert instantiations at once.

#define BSR_SPMM_EXPERTS 1
#include "bsr_spmm.cu"
