// Sparse conv given a kernel map (B4), for Hopper (sm_90a): bf16 operands,
// fp32 accumulation, the output in the features' dtype.
//
// Replaces the TPU kernel `ops/onehot_conv.py::onehot_sparse_conv` of the
// JAX package (Pallas `pallas_call`):
//   out_j = sum_k bf16(f[nbr[k, j]]) . bf16(W_k),   a missing neighbour adds
// zero, for an arbitrary map nbr int32[K, N_out] (an index outside [0,
// n_in) is missing).  The TPU kernel gathers with one-hot matmuls from a
// window of input rows that the map's canonical order keeps narrow; on the
// H100 the rows are gathered directly (the bf16 features of every workload
// of the library path fit the 50 MB L2), so no window is kept.
//
// The design, what bounds it and what is left: `map_conv.cuh`, shared with
// B7.  Here the products are one bf16 term of each operand, (TA, TB) =
// (1, 1), as the TPU kernel's `compute_dtype` bf16.  Any K up to 65,535
// offsets (the pair lists make K a loop count, not a shared-memory size).

#include "map_conv.cuh"

// Launch every pass up to `stage` on `stream` (see `map_conv.cuh`).
extern "C" int onehot_sparse_conv_forward(MAP_CONV_ENTRY_PARAMS) {
  return map_conv::forward<1, 1>(MAP_CONV_ARGS, (cudaStream_t)stream);
}

extern "C" const char* onehot_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
