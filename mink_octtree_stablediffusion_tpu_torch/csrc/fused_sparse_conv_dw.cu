// Fused sparse-conv weight gradient (dW) for Hopper (sm_90a): neighbour
// search + row gather + bf16 tensor-core GEMM with fp32 accumulation.
//
// Replaces the TPU kernel `ops/onehot_conv.py::_dkernel_fused` of the JAX
// package (Pallas `pallas_call`), the dW half of `_fused_conv`'s backward:
//   dW[k, Cin, Cout] = sum_j bf16(f[match_k(j)])^T . bf16(g_j)
// over the valid output rows j with a match for offset k, with the forward's
// query and match rule (`sparse_conv_common.cuh`), fp32 accumulation and an
// fp32 result.
//
// What bounds it on the H100: the same bytes as the forward -- the
// features, the cotangent, the keys and coordinates once, dW once -- at an
// arithmetic intensity far below the ~295 FLOP/byte of the tensor cores.
// What this first design does about it: the matches are searched in the
// kernel (no int32[N_out, K] map in device memory), a row tile without a
// match for the block's offset is skipped after one search, and the
// gathered rows go straight into shared memory as bf16.  What it does not
// do yet: the search and the gather are repeated for each (Cin, Cout) tile
// of an offset, and loads are not pipelined (no cp.async/TMA, no wgmma) --
// later work.
//
// Tiles: one 128-thread block per (offset k, 64-wide Cin tile, 64-wide Cout
// tile, split of the output rows).  The block walks its split in 64-row
// tiles; each warp owns 16 Cin rows x 64 Cout columns of dW_k as four 16x16
// wmma accumulators, fed by the gathered rows (the A operand, read
// transposed from shared memory) and the cotangent rows.  Splits keep the
// card busy when K x tiles is small (27 blocks at 4->4); they are summed
// with fp32 atomicAdd into the zeroed output, so the order of the fp32 sum
// over splits varies from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "sparse_conv_common.cuh"

namespace {

using namespace nvcuda;
using sparse_conv::Geom;

constexpr int BR = 64;       // output rows per tile (the GEMM's depth)
constexpr int BI = 64;       // Cin per block (4 warps x 16)
constexpr int BO = 64;       // Cout per block
constexpr int NTHREADS = 128;
constexpr int LDA = BI + 8;  // bf16 elements, multiple of 8 for wmma
constexpr int LDG = BO + 8;
constexpr int LDC = BO + 4;  // floats, multiple of 4 for wmma
constexpr int TARGET_BLOCKS = 1056;  // 8 blocks on each of 132 SMs

__global__ void __launch_bounds__(NTHREADS) fused_sparse_conv_dw_kernel(
    const float* __restrict__ feat, const float* __restrict__ grad,
    const int* __restrict__ in_keys, const int* __restrict__ out_coords,
    const unsigned char* __restrict__ out_valid, float* __restrict__ dw,
    int n_in, int n_out, int cin, int cout, int tiles_per_split,
    const Geom g) {
  __shared__ __align__(128) __nv_bfloat16 sA[BR * LDA];  // gathered f rows
  __shared__ __align__(128) __nv_bfloat16 sG[BR * LDG];  // g rows
  __shared__ __align__(128) float sC[BI * LDC];
  __shared__ int sIdx[BR];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n_co = (cout + BO - 1) / BO;
  const int ci0 = (blockIdx.x / n_co) * BI;
  const int co0 = (blockIdx.x % n_co) * BO;
  const int k = blockIdx.y;
  const int n_tiles = (n_out + BR - 1) / BR;
  const int t_end = min(n_tiles, (blockIdx.z + 1) * tiles_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BO / 16];
#pragma unroll
  for (int j = 0; j < BO / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  bool touched = false;  // block-uniform: some row of the split matched
  for (int t = blockIdx.z * tiles_per_split; t < t_end; ++t) {
    const int row0 = t * BR;
    // 1. each row of the tile searches its query key for offset k
    int found = -1;
    if (tid < BR) {
      int coord[4];
      sparse_conv::load_coord(coord, row0 + tid, n_out, out_coords, out_valid);
      found = sparse_conv::find_neighbor(coord, k, g, in_keys, n_in);
      sIdx[tid] = found;
    }
    if (!__syncthreads_or(found >= 0)) continue;  // no match in the tile
    touched = true;

    // 2. gather the matched f rows and the g rows (bf16; a row without a
    // match, and anything past Cin / Cout, is zero in both)
    for (int e = tid; e < BR * BI; e += NTHREADS) {
      const int r = e / BI, c = e % BI, src = sIdx[r], cc = ci0 + c;
      const float v = (src >= 0 && cc < cin) ? __ldg(feat + (size_t)src * cin + cc) : 0.0f;
      sA[r * LDA + c] = __float2bfloat16(v);
    }
    for (int e = tid; e < BR * BO; e += NTHREADS) {
      const int r = e / BO, c = e % BO, cc = co0 + c;
      const float v = (sIdx[r] >= 0 && cc < cout)
                          ? __ldg(grad + (size_t)(row0 + r) * cout + cc) : 0.0f;
      sG[r * LDG + c] = __float2bfloat16(v);
    }
    __syncthreads();
    // 3. dW_k tile += A^T . G: A^T is sA read column-major
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, sA + kk * LDA + warp * 16, LDA);
#pragma unroll
      for (int j = 0; j < BO / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sG + kk * LDG + j * 16, LDG);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
  if (!touched) return;

  // 4. add the block's partial sum into dW (fp32 atomics across splits)
#pragma unroll
  for (int j = 0; j < BO / 16; ++j)
    wmma::store_matrix_sync(sC + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  float* dwk = dw + (size_t)k * cin * cout;
  for (int e = tid; e < BI * BO; e += NTHREADS) {
    const int r = e / BO, c = e % BO, gi = ci0 + r, gc = co0 + c;
    if (gi < cin && gc < cout) atomicAdd(dwk + (size_t)gi * cout + gc, sC[r * LDC + c]);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// feat fp32 [n_in, cin], grad fp32 [n_out, cout], in_keys int32 [n_in]
// (sorted, INT32_MAX on padding rows), out_coords int32 [n_out, 4],
// out_valid bool [n_out]; dw fp32 [k, cin, cout] must be zeroed by the
// caller.  offs [k*3], s_in [3] and cells [3] are host arrays.
extern "C" int fused_sparse_conv_dkernel(
    const void* feat, const void* grad, const void* in_keys,
    const void* out_coords, const void* out_valid, void* dw, int n_in,
    int n_out, int cin, int cout, int k, const int* offs, const int* s_in,
    const int* cells, void* stream) {
  if (k < 1 || k > sparse_conv::MAX_K || n_out < 1 || cout < 1 || cin < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g = sparse_conv::make_geom(k, offs, s_in, cells);
  const int tiles = ((cin + BI - 1) / BI) * ((cout + BO - 1) / BO);
  const int n_tiles = (n_out + BR - 1) / BR;
  int splits = (TARGET_BLOCKS + tiles * k - 1) / (tiles * k);
  splits = splits < 1 ? 1 : (splits > n_tiles ? n_tiles : splits);
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  splits = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid(tiles, k, splits);
  fused_sparse_conv_dw_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)grad, (const int*)in_keys,
      (const int*)out_coords, (const unsigned char*)out_valid, (float*)dw,
      n_in, n_out, cin, cout, tiles_per_split, g);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sparse_conv_dw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
