// Sparse conv given a kernel map (B7), for Hopper (sm_90a): the features'
// own precision times the fp32 weight, fp32 accumulation, the output in
// the features' dtype.
//
// Replaces the TPU kernel `ops/pallas_conv.py::pallas_sparse_conv` of the
// JAX package (Pallas `pallas_call`): the same function as B4,
//   out_j = sum_k f[nbr[k, j]] . W_k,   a missing neighbour adds zero,
// but with the products as the JAX kernel forms them: its body multiplies
// the gathered rows, in the features' dtype, by the kernel as given (fp32),
// so bf16 features meet an fp32 weight and only the output is rounded to
// bf16; fp32 features give fp32 products.  Indices outside [0, n_in) are
// missing.
//
// The design, what bounds it and what is left: `map_conv.cuh`, shared with
// B4.  The fp32 accuracy on the tensor cores comes from split terms:
//   - bf16 features: (TA, TB) = (1, 3), the features exact in one bf16
//     term times the weight's three terms, 3 bf16 products;
//   - fp32 features: (3, 3), the 6 products of the terms with i + j <= 2
//     (the header says why bf16 terms and not 3xTF32).
// The result matches an fp32 product to summation order: the card checks
// hold fp32 features to 2e-5 of max|ref|, a limit one TF32 or bf16
// rounding of the operands exceeds.  Any K up to 65,535 offsets.

#include "map_conv.cuh"

// Launch every pass up to `stage` on `stream` (see `map_conv.cuh`).
extern "C" int pallas_sparse_conv_forward(MAP_CONV_ENTRY_PARAMS) {
  return feat_bf16
             ? map_conv::forward<1, 3>(MAP_CONV_ARGS, (cudaStream_t)stream)
             : map_conv::forward<3, 3>(MAP_CONV_ARGS, (cudaStream_t)stream);
}

extern "C" const char* pallas_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
