// Fused sparse-conv forward for Hopper (sm_90a): neighbour search + row
// gather + bf16 tensor-core GEMM with fp32 accumulation, in one kernel.
//
// Replaces the TPU kernel `ops/onehot_conv.py::_fused_impl` of the JAX
// package (Pallas `pallas_call`), reached there through
// `fused_sparse_conv`.  For every output row j and kernel offset k:
//   q = out_coord_j + delta_k must lie on the input lattice
//       (q - floor(q / s_in) * s_in == 0), inside the extent, and row j must
//       be valid; then its int32 flat key b*prod(cells) + row-major(pos) is
//       searched in the sorted input keys, and
//   out_j = sum_k f[match_k(j)] . W_k   (a miss adds zero).
// One kernel covers plain k3s1, strided k3s2, pinned transpose k2s2 and
// generative k2s2 convs: only the offsets and strides differ.
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

namespace {

using namespace nvcuda;

constexpr int MAX_K = 125;  // up to a 5x5x5 cube
constexpr int BM = 64;      // output rows per block
constexpr int BN = 64;      // output channels per block
constexpr int BK = 32;      // input channels per chunk
constexpr int NTHREADS = 128;
constexpr int LDA = BK + 8;  // bf16 elements, multiple of 8 for wmma
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // floats, multiple of 4 for wmma

struct Geom {
  int k;               // number of offsets
  int s_in[3];         // input lattice stride
  int cells[3];        // input lattice cells per axis
  int offs[MAX_K * 3]; // absolute offsets (sign applied for transposes)
};

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(NTHREADS) fused_sparse_conv_kernel(
    const float* __restrict__ feat, const float* __restrict__ weight,
    const int* __restrict__ in_keys, const int* __restrict__ out_coords,
    const unsigned char* __restrict__ out_valid, float* __restrict__ out,
    int n_in, int n_out, int cin, int cout, const Geom g) {
  __shared__ __align__(128) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 sB[BK * LDB];
  __shared__ __align__(128) float sC[BM * LDC];
  __shared__ int sIdx[BM];
  __shared__ int sCoord[BM][4];  // batch (-1 = invalid row), x, y, z

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  if (tid < BM) {
    const int r = row0 + tid;
    if (r < n_out && out_valid[r]) {
      for (int d = 0; d < 4; ++d) sCoord[tid][d] = out_coords[(size_t)r * 4 + d];
    } else {
      sCoord[tid][0] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
  __syncthreads();

  for (int k = 0; k < g.k; ++k) {
    // 1. each row searches its query key in the sorted input keys
    int found = -1;
    if (tid < BM && sCoord[tid][0] >= 0) {
      int key = sCoord[tid][0];
      bool ok = true;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int q = sCoord[tid][1 + d] + g.offs[k * 3 + d];
        const int p = floor_div(q, g.s_in[d]);
        ok = ok && (q == p * g.s_in[d]) && p >= 0 && p < g.cells[d];
        key = key * g.cells[d] + p;
      }
      if (ok) {
        int lo = 0, hi = n_in;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(in_keys + mid) < key) lo = mid + 1; else hi = mid;
        }
        if (lo < n_in && __ldg(in_keys + lo) == key) found = lo;
      }
    }
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
      // ... and the W_k chunk (bf16, zero past Cin / Cout)
      for (int e = tid; e < BK * BN; e += NTHREADS) {
        const int r = e / BN, c = e % BN, cr = c0 + r, cc = col0 + c;
        const float v = (cr < cin && cc < cout) ? __ldg(wk + (size_t)cr * cout + cc) : 0.0f;
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
// feat fp32 [n_in, cin], weight fp32 [k, cin, cout], in_keys int32 [n_in]
// (sorted, INT32_MAX on padding rows), out_coords int32 [n_out, 4],
// out_valid bool [n_out], out fp32 [n_out, cout]; offs [k*3], s_in [3] and
// cells [3] are host arrays.
extern "C" int fused_sparse_conv_forward(
    const void* feat, const void* weight, const void* in_keys,
    const void* out_coords, const void* out_valid, void* out, int n_in,
    int n_out, int cin, int cout, int k, const int* offs, const int* s_in,
    const int* cells, void* stream) {
  if (k < 1 || k > MAX_K || n_out < 1 || cout < 1 || cin < 1) return (int)cudaErrorInvalidValue;
  Geom g;
  g.k = k;
  for (int d = 0; d < 3; ++d) {
    g.s_in[d] = s_in[d];
    g.cells[d] = cells[d];
  }
  for (int i = 0; i < k * 3; ++i) g.offs[i] = offs[i];
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  fused_sparse_conv_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)weight, (const int*)in_keys,
      (const int*)out_coords, (const unsigned char*)out_valid, (float*)out,
      n_in, n_out, cin, cout, g);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
