// Sparse conv given a kernel map, for Hopper (sm_90a): a direct
// gather-GEMM in the features' own dtype with fp32 accumulation.
//
// Replaces the TPU kernel `ops/pallas_conv.py::pallas_sparse_conv` of the
// JAX package (B7, Pallas `pallas_call`): the same function as B4,
//   out_j = sum_k f[nbr[k, j]] . W_k,   a missing neighbour (-1) adds zero,
// but computed in the features' dtype, as the JAX kernel does (it has no
// `compute_dtype`): bf16 features give bf16 products (the weight rounded to
// bf16), fp32 features fp32 products, both summed in fp32; the output is in
// the features' dtype.
//
// What the TPU kernel does: the whole features and weights sit in VMEM, and
// for each offset a dynamic row gather feeds a dot into an fp32 accumulator.
// This design keeps that shape without any window: each block gathers its
// rows straight from device memory (the L2 cache, 50 MB, holds the room's
// and the finest level's features whole) for one offset and one channel
// chunk at a time, and accumulates in registers across the K x Cin-chunk
// loop.  An offset with no row of the tile mapped is skipped.  Indices
// outside [0, n_in) are read as missing.
//   - bf16 features: wmma bf16 16x16x16 with fp32 accumulators; one
//     128-thread block per (64-row tile, 64-wide Cout tile).
//   - fp32 features: an fp32 FMA loop, no TF32 or bf16 rounding (the result
//     matches the fp32 plain version to summation order); one 256-thread
//     block per (64-row tile, 64-wide Cout tile), 4 x 4 outputs a thread.
//
// What bounds it on the H100: the bytes it must move (the map, the
// features, the weights and the output once) at the library path's widths;
// in fp32 at 512 -> 512 the FMA loop is operation bound on the CUDA cores,
// not the tensor cores.  What it does not do yet: each Cout tile re-gathers
// its rows, gathers are not pipelined, and fp32 does not use the tensor
// cores (3xTF32 would) -- later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;  // output rows per block
constexpr int BN = 64;  // output channels per block

// -- bf16: wmma --------------------------------------------------------------

constexpr int WK = 32;  // input channels per chunk
constexpr int W_THREADS = 128;
constexpr int LDA = WK + 8;
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

__global__ void __launch_bounds__(W_THREADS) pallas_sparse_conv_wmma(
    const __nv_bfloat16* __restrict__ feat, const float* __restrict__ weight,
    const int* __restrict__ nbr, __nv_bfloat16* __restrict__ out, int n_in, int n_out,
    int cin, int cout, int k) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[WK * LDB];
  __shared__ __align__(128) float sC[BM * LDC];
  __shared__ int sIdx[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int kk = 0; kk < k; ++kk) {
    int v = -1;
    if (tid < BM) {
      const int r = row0 + tid;
      v = r < n_out ? __ldg(nbr + (size_t)kk * n_out + r) : -1;
      if (v >= n_in) v = -1;
      sIdx[tid] = v;
    }
    if (!__syncthreads_or(v >= 0)) continue;  // no row of the tile mapped
    const float* wk = weight + (size_t)kk * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += WK) {
      for (int e = tid; e < BM * WK; e += W_THREADS) {
        const int r = e / WK, c = e % WK, src = sIdx[r], cc = c0 + c;
        sA[r * LDA + c] = (src >= 0 && cc < cin) ? feat[(size_t)src * cin + cc]
                                                 : __float2bfloat16(0.0f);
      }
      for (int e = tid; e < WK * BN; e += W_THREADS) {
        const int r = e / BN, c = e % BN, cr = c0 + r, cc = col0 + c;
        const float w = (cr < cin && cc < cout) ? __ldg(wk + (size_t)cr * cout + cc) : 0.0f;
        sB[r * LDB + c] = __float2bfloat16(w);
      }
      __syncthreads();
#pragma unroll
      for (int kq = 0; kq < WK; kq += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sA + warp * 16 * LDA + kq, LDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sB + kq * LDB + j * 16, LDB);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(sC + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += W_THREADS) {
    const int r = e / BN, c = e % BN, gr = row0 + r, gc = col0 + c;
    if (gr < n_out && gc < cout) out[(size_t)gr * cout + gc] = __float2bfloat16(sC[r * LDC + c]);
  }
}

// -- fp32: FMA -----------------------------------------------------------------

constexpr int FK = 16;  // input channels per chunk
constexpr int F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS) pallas_sparse_conv_fma(
    const float* __restrict__ feat, const float* __restrict__ weight,
    const int* __restrict__ nbr, float* __restrict__ out, int n_in, int n_out, int cin,
    int cout, int k) {
  __shared__ float sA[FK][BM];  // gathered rows, channel-major
  __shared__ float sB[FK][BN];
  __shared__ int sIdx[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // columns tx + 16j, rows ty + 16i
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  float acc[4][4] = {};

  for (int kk = 0; kk < k; ++kk) {
    int v = -1;
    if (tid < BM) {
      const int r = row0 + tid;
      v = r < n_out ? __ldg(nbr + (size_t)kk * n_out + r) : -1;
      if (v >= n_in) v = -1;
      sIdx[tid] = v;
    }
    if (!__syncthreads_or(v >= 0)) continue;
    const float* wk = weight + (size_t)kk * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += FK) {
      for (int e = tid; e < BM * FK; e += F_THREADS) {
        const int r = e / FK, c = e % FK, src = sIdx[r], cc = c0 + c;
        sA[c][r] = (src >= 0 && cc < cin) ? __ldg(feat + (size_t)src * cin + cc) : 0.0f;
      }
      for (int e = tid; e < FK * BN; e += F_THREADS) {
        const int r = e / BN, c = e % BN, cr = c0 + r, cc = col0 + c;
        sB[r][c] = (cr < cin && cc < cout) ? __ldg(wk + (size_t)cr * cout + cc) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < FK; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = sB[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = row0 + ty + 16 * i, gc = col0 + tx + 16 * j;
      if (gr < n_out && gc < cout) out[(size_t)gr * cout + gc] = acc[i][j];
    }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// feat [n_in, cin] fp32 (feat_bf16 == 0) or bf16, weight fp32 [k, cin,
// cout], nbr int32 [k, n_out] (-1 = missing), out [n_out, cout] in the
// features' dtype.
extern "C" int pallas_sparse_conv_forward(const void* feat, int feat_bf16, const void* weight,
                                          const void* nbr, void* out, int n_in, int n_out,
                                          int cin, int cout, int k, void* stream) {
  if (k < 1 || n_out < 1 || cout < 1 || cin < 1 || n_in < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  cudaStream_t s = (cudaStream_t)stream;
  if (feat_bf16) {
    pallas_sparse_conv_wmma<<<grid, W_THREADS, 0, s>>>(
        (const __nv_bfloat16*)feat, (const float*)weight, (const int*)nbr,
        (__nv_bfloat16*)out, n_in, n_out, cin, cout, k);
  } else {
    pallas_sparse_conv_fma<<<grid, F_THREADS, 0, s>>>(
        (const float*)feat, (const float*)weight, (const int*)nbr, (float*)out, n_in, n_out,
        cin, cout, k);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pallas_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
