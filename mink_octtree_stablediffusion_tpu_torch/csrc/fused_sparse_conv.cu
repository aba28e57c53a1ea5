// Fused sparse-conv forward for Hopper (sm_90a): neighbour search + row
// gather + bf16 tensor-core GEMM with fp32 accumulation, in one kernel.
//
// Replaces the TPU kernel `ops/onehot_conv.py::_fused_impl` of the JAX
// package (Pallas `pallas_call`), reached there through
// `fused_sparse_conv`, in both of its directions:
//   - the forward conv (B1): for every output row j and kernel offset k,
//     out_j = sum_k f[match_k(j)] . W_k   (a miss adds zero), with the match
//     rule of `sparse_conv_common.cuh`;
//   - the dF backward (B2, `_FusedStatic.flipped`): the same search run in
//     the transpose direction -- the grids swap roles, the offsets negate,
//     the searched lattice is the forward's output lattice -- over the
//     cotangent g with W_k read transposed (`transpose_weight`: the weight
//     stays the forward's [k, Cout, Cin] in memory, no transposed copy).
// One kernel covers plain k3s1, strided k3s2, pinned transpose k2s2 and
// generative k2s2 convs in both directions: only the offsets and strides
// differ.
//
// What bounds it on the H100: at the widths of the main path (Cin, Cout in
// 1..512, a few thousand to 131072 rows) the arithmetic intensity of one
// conv is far below the ~295 FLOP/byte the card needs to be compute bound,
// so its bound is the bytes it must move — the features, the weights, the
// keys and coordinates once, the output once.  What this first design does
// about it: the query keys are computed in the kernel from the output
// coordinates (no int32[N_out, K] map round-trips through device memory),
// each output tile searches each offset once and skips offsets for which
// no row of the tile has a neighbour, and the gathered rows go straight
// into shared memory as bf16.  What it does not do yet: the search is
// repeated for each Cout tile, the weights are re-read by every row tile,
// and loads are not pipelined (no cp.async/TMA, no wgmma) — later work.
//
// Tiles: one 128-thread block per (64-row output tile, 64-wide Cout tile);
// each warp owns 16 rows x 64 columns as four 16x16 wmma accumulators.
// Ragged rows, Cin and Cout are zero-padded in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "sparse_conv_common.cuh"

namespace {

using namespace nvcuda;
using sparse_conv::Geom;

constexpr int BM = 64;      // output rows per block
constexpr int BN = 64;      // output channels per block
constexpr int BK = 32;      // input channels per chunk
constexpr int NTHREADS = 128;
constexpr int LDA = BK + 8;  // bf16 elements, multiple of 8 for wmma
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // floats, multiple of 4 for wmma

// kTransW: W_k is stored [cout][cin] (the forward's weight, read by dF)
// instead of [cin][cout].
template <bool kTransW>
__global__ void __launch_bounds__(NTHREADS) fused_sparse_conv_kernel(
    const float* __restrict__ feat, const float* __restrict__ weight,
    const int* __restrict__ in_keys, const int* __restrict__ out_coords,
    const unsigned char* __restrict__ out_valid, float* __restrict__ out,
    int n_in, int n_out, int cin, int cout, const Geom g) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[BK * LDB];
  __shared__ __align__(128) float sC[BM * LDC];
  __shared__ int sIdx[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  int coord[4] = {-1, 0, 0, 0};  // this thread's output row (tid < BM)
  if (tid < BM) sparse_conv::load_coord(coord, row0 + tid, n_out, out_coords, out_valid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k = 0; k < g.k; ++k) {
    // 1. each row searches its query key in the sorted input keys
    const int found = tid < BM ? sparse_conv::find_neighbor(coord, k, g, in_keys, n_in) : -1;
    if (tid < BM) sIdx[tid] = found;
    if (!__syncthreads_or(found >= 0)) continue;  // no neighbour in the tile

    const float* wk = weight + (size_t)k * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      // 2. gather the matched rows (bf16, zero on a miss or past Cin)
      for (int e = tid; e < BM * BK; e += NTHREADS) {
        const int r = e / BK, c = e % BK, src = sIdx[r], cc = c0 + c;
        const float v = (src >= 0 && cc < cin) ? __ldg(feat + (size_t)src * cin + cc) : 0.0f;
        sA[r * LDA + c] = __float2bfloat16(v);
      }
      // ... and the W_k chunk (bf16, zero past Cin / Cout); neighbouring
      // threads read neighbouring addresses in either layout
      for (int e = tid; e < BK * BN; e += NTHREADS) {
        const int r = kTransW ? e % BK : e / BN;
        const int c = kTransW ? e / BK : e % BN;
        const int cr = c0 + r, cc = col0 + c;
        float v = 0.0f;
        if (cr < cin && cc < cout)
          v = __ldg(wk + (kTransW ? (size_t)cc * cin + cr : (size_t)cr * cout + cc));
        sB[r * LDB + c] = __float2bfloat16(v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sA + warp * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sB + kk * LDB + j * 16, LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }

  // 3. store fp32 through shared memory, masking the ragged edges
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(sC + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN, gr = row0 + r, gc = col0 + c;
    if (gr < n_out && gc < cout) out[(size_t)gr * cout + gc] = sC[r * LDC + c];
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// feat fp32 [n_in, cin], weight fp32 [k, cin, cout] ([k, cout, cin] when
// transpose_weight != 0), in_keys int32 [n_in] (sorted, INT32_MAX on
// padding rows), out_coords int32 [n_out, 4], out_valid bool [n_out], out
// fp32 [n_out, cout]; offs [k*3], s_in [3] and cells [3] are host arrays.
extern "C" int fused_sparse_conv_forward(
    const void* feat, const void* weight, const void* in_keys,
    const void* out_coords, const void* out_valid, void* out, int n_in,
    int n_out, int cin, int cout, int k, const int* offs, const int* s_in,
    const int* cells, int transpose_weight, void* stream) {
  if (k < 1 || k > sparse_conv::MAX_K || n_out < 1 || cout < 1 || cin < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g = sparse_conv::make_geom(k, offs, s_in, cells);
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  auto kernel = transpose_weight ? fused_sparse_conv_kernel<true> : fused_sparse_conv_kernel<false>;
  kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)weight, (const int*)in_keys,
      (const int*)out_coords, (const unsigned char*)out_valid, (float*)out,
      n_in, n_out, cin, cout, g);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
