// Sparse conv given a kernel map, for Hopper (sm_90a): a windowed
// gather-GEMM with bf16 tensor-core products and fp32 accumulation.
//
// Replaces the TPU kernel `ops/onehot_conv.py::onehot_sparse_conv` of the
// JAX package (B4, Pallas `pallas_call`):
//   out_j = sum_k f[nbr[k, j]] . W_k,   a missing neighbour (-1) adds zero,
// for an arbitrary map nbr int32[K, N_out].  The operands are rounded to
// bf16 (the JAX kernel's default `compute_dtype`: its one-hot gather copies
// the bf16 rows exactly), the products summed in fp32, the output written
// in the features' dtype (fp32 or bf16).
//
// What the TPU kernel exploits, and this one too: grids are in canonical
// flat-key order, so each row nbr[k, :] increases over its valid entries
// and all K neighbourhoods of an output tile lie in one narrow window of
// input rows.  The TPU gathers from that window with one-hot matmuls; here
// each block finds its tile's window [lo, hi] over all K offsets, stages it
// into shared memory in TW-row x 32-channel chunks with cp.async (fp32
// features; bf16 features are staged by plain loads), and gathers each
// offset's rows from shared memory into the MMA's A tile.  The banding is a
// performance property only: a window wider than TW rows (shuffled or
// duplicated maps, or a tile where occupancy jumps) is walked chunk by
// chunk, as the TPU's `fori_loop` over `nch` does, and an offset with no
// row of the tile in the current chunk is skipped.  Indices outside
// [0, n_in) are read as missing.
//
// What bounds it on the H100: at the widths of the library path (3 -> 32
// on a 26,098-point room, 32 -> 32 on the finest octree level, 512 -> 512
// on an encoder level) the arithmetic intensity is far below the ~295
// FLOP/byte the card needs to be compute bound, so its bound is the bytes
// it must move: the map (4 * K * N_out), the features, the weights and the
// output once.  What this first design does about it: the features are
// read once per window chunk and block (not once per offset), in 32-channel
// chunks, so Cin = 3 pads to the MMA depth 16, not to 128 lanes.  What it
// does not do yet: the window is re-read by every Cout tile, the weights by
// every row tile and window chunk, and loads are not pipelined across
// chunks (no double buffering, no TMA, no wgmma) -- later work.
//
// Tiles: one 128-thread block per (64-row output tile, 64-wide Cout tile);
// each warp owns 16 rows x 64 columns as four 16x16 wmma accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>

namespace {

using namespace nvcuda;

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output channels per block
constexpr int CK = 32;       // input channels per chunk
constexpr int TW = 256;      // window rows per chunk
constexpr int NTHREADS = 128;
constexpr int LDA = CK + 8;  // bf16 elements, a multiple of 8 for wmma
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // floats, a multiple of 4 for wmma
constexpr int MAX_K = 343;   // up to a 7x7x7 cube

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// dynamic shared memory: window (reused as the fp32 output stage), A, B,
// the tile's map entries, the per-offset window rows, the window bounds
template <typename T>
struct Smem {
  static constexpr size_t win = align128(
      (size_t)TW * CK * sizeof(T) > (size_t)BM * LDC * 4 ? (size_t)TW * CK * sizeof(T)
                                                         : (size_t)BM * LDC * 4);
  static constexpr size_t a = align128((size_t)BM * LDA * 2);
  static constexpr size_t b = align128((size_t)CK * LDB * 2);
  static constexpr size_t rel = (size_t)BM * 4;
  static size_t bytes(int k) { return win + a + b + rel + 8 + (size_t)k * BM * 4; }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS) onehot_sparse_conv_kernel(
    const T* __restrict__ feat, const float* __restrict__ weight,
    const int* __restrict__ nbr, T* __restrict__ out, int n_in, int n_out,
    int cin, int cout, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sWin = reinterpret_cast<T*>(smem);
  float* sC = reinterpret_cast<float*>(smem);  // after the last window
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem + Smem<T>::win);
  __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(smem + Smem<T>::win + Smem<T>::a);
  int* sRel = reinterpret_cast<int*>(smem + Smem<T>::win + Smem<T>::a + Smem<T>::b);
  int* sLoHi = sRel + BM;
  int* sIdx = sLoHi + 2;  // [k][BM]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // 1. the tile's map entries and its window [lo, hi] over all K offsets
  if (tid == 0) {
    sLoHi[0] = INT_MAX;
    sLoHi[1] = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int e = tid; e < k * BM; e += NTHREADS) {
    const int kk = e / BM, r = row0 + e % BM;
    int v = r < n_out ? __ldg(nbr + (size_t)kk * n_out + r) : -1;
    if (v >= n_in) v = -1;
    sIdx[e] = v;
    if (v >= 0) {
      lo = min(lo, v);
      hi = max(hi, v);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tid % 32 == 0) {
    atomicMin(sLoHi, lo);
    atomicMax(sLoHi + 1, hi);
  }
  __syncthreads();
  lo = sLoHi[0];
  hi = sLoHi[1];

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int nch = hi >= 0 ? (hi - lo) / TW + 1 : 0;  // 0: an empty tile
  for (int c0 = 0; c0 < cin; c0 += CK) {
    const int cw = min(CK, cin - c0);
    for (int ch = 0; ch < nch; ++ch) {
      const int base = lo + ch * TW;
      // 2. stage window rows [base, base + TW) x channels [c0, c0 + CK)
      __syncthreads();  // the previous chunk's gathers are done
      for (int e = tid; e < TW * CK; e += NTHREADS) {
        const int r = base + e / CK, c = e % CK;
        const bool ok = r <= hi && c < cw;
        const T* src = ok ? feat + (size_t)r * cin + c0 + c : feat;
        if constexpr (sizeof(T) == 4) {
          cp_async4(sWin + e, src, ok);
        } else {
          sWin[e] = ok ? *src : from_float<T>(0.0f);
        }
      }
      if constexpr (sizeof(T) == 4) {
        asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      }
      __syncthreads();
      for (int kk = 0; kk < k; ++kk) {
        // 3. the rows whose offset-kk neighbour lies in this chunk
        int rel = -1;
        if (tid < BM) {
          const int v = sIdx[kk * BM + tid];
          if (v >= base && v < base + TW) rel = v - base;
          sRel[tid] = rel;
        }
        if (!__syncthreads_or(rel >= 0)) continue;
        for (int e = tid; e < BM * CK; e += NTHREADS) {
          const int r = e / CK, c = e % CK, v = sRel[r];
          sA[r * LDA + c] = __float2bfloat16(v >= 0 ? to_float(sWin[v * CK + c]) : 0.0f);
        }
        const float* wk = weight + (size_t)kk * cin * cout;
        for (int e = tid; e < CK * BN; e += NTHREADS) {
          const int r = e / BN, c = e % BN, cr = c0 + r, cc = col0 + c;
          const float v = (cr < cin && cc < cout) ? __ldg(wk + (size_t)cr * cout + cc) : 0.0f;
          sB[r * LDB + c] = __float2bfloat16(v);
        }
        __syncthreads();
        // 4. the GEMM: bf16 operands, fp32 accumulation
#pragma unroll
        for (int kq = 0; kq < CK; kq += 16) {
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
  }

  // 5. store through shared memory in the features' dtype, masking the
  // ragged edges (an empty tile writes zeros)
  __syncthreads();
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(sC + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += NTHREADS) {
    const int r = e / BN, c = e % BN, gr = row0 + r, gc = col0 + c;
    if (gr < n_out && gc < cout) out[(size_t)gr * cout + gc] = from_float<T>(sC[r * LDC + c]);
  }
}

template <typename T>
int launch(const void* feat, const void* weight, const void* nbr, void* out, int n_in,
           int n_out, int cin, int cout, int k, cudaStream_t stream) {
  const size_t bytes = Smem<T>::bytes(k);
  cudaError_t e = cudaFuncSetAttribute(onehot_sparse_conv_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  onehot_sparse_conv_kernel<T><<<grid, NTHREADS, bytes, stream>>>(
      (const T*)feat, (const float*)weight, (const int*)nbr, (T*)out, n_in, n_out, cin, cout, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// feat [n_in, cin] fp32 (feat_bf16 == 0) or bf16, weight fp32 [k, cin,
// cout], nbr int32 [k, n_out] (-1 = missing), out [n_out, cout] in the
// features' dtype.
extern "C" int onehot_sparse_conv_forward(const void* feat, int feat_bf16, const void* weight,
                                          const void* nbr, void* out, int n_in, int n_out,
                                          int cin, int cout, int k, void* stream) {
  if (k < 1 || k > MAX_K || n_out < 1 || cout < 1 || cin < 1 || n_in < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return feat_bf16 ? launch<__nv_bfloat16>(feat, weight, nbr, out, n_in, n_out, cin, cout, k, s)
                   : launch<float>(feat, weight, nbr, out, n_in, n_out, cin, cout, k, s);
}

extern "C" const char* onehot_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
