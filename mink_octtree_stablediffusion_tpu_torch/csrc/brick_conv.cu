// Dense-volume (brick) k=3 s=1 conv for Hopper (sm_90a): bf16 tensor-core
// implicit GEMM with fp32 accumulation, forward and dF.
//
// Replaces the TPU kernel `ops/vol_conv.py::vol_conv_tiles` (`_kernel`,
// Pallas `pallas_call`) of the JAX package, in both of its uses on the
// brick route (`brick_pallas_conv`):
//   - the forward (B5): out[p] = sum_k vol[p + delta_k] . W_k over the 27
//     offsets, on the zero-padded volume the rows were scattered into;
//   - the dF pass: the same conv of the cotangent volume with the
//     mirrored-transposed kernel W'[k] = W[26 - k]^T (`mirror`: the weight
//     stays the forward's [27, Cin, Cout] in memory and is read mirrored).
// The TPU's 128-lane channel padding, its z + 8 padding, its VMEM-resident
// z column and its brick-order output are Mosaic mechanics and are not
// carried over: channels are padded to the MMA depth (16), the output is
// a dense fp32 [b, x, y, z, cout] volume.
//
// What bounds it on the H100: the dense work, 2 * 27 * cells * Cin * Cout
// operations, is operation bound at 128 -> 128 (928 GFLOP on the 1,048,576
// cells of the VAE decoder's stride-2 level) and byte bound at narrow
// widths (the volume read, the fp32 output written).  What this first
// design does about it: each 16-channel chunk of a tile's halo is loaded
// once into shared memory and serves all 27 taps as shifted 16 x 16 MMA
// operands (no im2col copy); a chunk whose halo is all zero (most tiles
// of a sparse octree level) is skipped after its load, so empty space
// costs a read of the volume and a write of zeros.  What it does not do
// yet: the weights are re-read by every tile, and loads are not pipelined
// (no cp.async/TMA, no wgmma) -- later work.
//
// Blocks: one 256-thread block per (4 x 4 x 16-cell tile, NT-wide Cout
// tile), NT in {16, 32, 64} after Cout.  Each warp owns two z-runs x NT
// columns as 16 x 16 wmma accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "brick_common.cuh"

namespace {

using namespace nvcuda;
using namespace brick;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = RUNS / NWARPS;  // z-runs per warp

template <int NT>
struct Layout {
  static constexpr int LDW = NT + 8;  // bf16, a multiple of 8 for wmma
  static constexpr size_t halo = (size_t)HALO * CK * 2;
  static constexpr size_t weights = (size_t)27 * CK * LDW * 2;
  static constexpr size_t stage = (size_t)NWARPS * 256 * 4;
  static constexpr size_t bytes = halo + weights + stage;
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS) brick_conv_kernel(
    const __nv_bfloat16* __restrict__ vol, const float* __restrict__ w,
    float* __restrict__ out, int x, int y, int z, int cs, int cin, int cout,
    int mirror) {
  constexpr int LDW = Layout<NT>::LDW, NF = NT / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sW = sH + HALO * CK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* sC = reinterpret_cast<float*>(sW + 27 * CK * LDW) + warp * 256;
  const Tile o = tile_origin(blockIdx.x, x, y, z);
  const int co0 = blockIdx.y * NT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RPW][NF];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[r][j], 0.0f);

  for (int c0 = 0; c0 < cin; c0 += CK) {
    __syncthreads();  // every warp is done with the previous chunk
    const bool nz = load_halo(sH, vol, o, c0, x, y, z, cs, tid, NTHREADS);
    if (!__syncthreads_or(nz)) continue;  // an all-zero halo adds nothing
    // W_k rows [c0, c0 + 16) x columns [co0, co0 + NT) as bf16; zero past
    // Cin and Cout
    for (int e = tid; e < 27 * CK * NT; e += NTHREADS) {
      const int j = e % NT, r = (e / NT) % CK, k = e / (NT * CK);
      const int ci = c0 + r, co = co0 + j;
      float v = 0.0f;
      if (ci < cin && co < cout)
        v = mirror ? __ldg(w + ((size_t)(26 - k) * cout + co) * cin + ci)
                   : __ldg(w + ((size_t)k * cin + ci) * cout + co);
      sW[(k * CK + r) * LDW + j] = __float2bfloat16(v);
    }
    __syncthreads();
    for (int k = 0; k < 27; ++k) {
      const int dx = k / 9, dy = (k / 3) % 3, dz = k % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j)
        wmma::load_matrix_sync(fb[j], sW + k * CK * LDW + j * 16, LDW);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int run = warp * RPW + r, rx = run / TY, ry = run % TY;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        // 16 consecutive halo cells along z, shifted by the tap
        wmma::load_matrix_sync(
            fa, sH + (((rx + dx) * HY + ry + dy) * HZ + dz) * CK, CK);
#pragma unroll
        for (int j = 0; j < NF; ++j)
          wmma::mma_sync(acc[r][j], fa, fb[j], acc[r][j]);
      }
    }
  }

  // every cell of the tile inside the volume is written, zeros included
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int run = warp * RPW + r;
    const int gx = o.x0 + run / TY, gy = o.y0 + run % TY;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(sC, acc[r][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gz = o.z0 + e / 16, co = co0 + j * 16 + e % 16;
        if (gx < x && gy < y && gz < z && co < cout)
          out[((((size_t)o.b * x + gx) * y + gy) * z + gz) * cout + co] = sC[e];
      }
      __syncwarp();
    }
  }
}

template <int NT>
int launch(const void* vol, const void* w, void* out, int b, int x, int y,
           int z, int cs, int cin, int cout, int mirror, cudaStream_t stream) {
  const size_t smem = Layout<NT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      brick_conv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles(b, x, y, z), (cout + NT - 1) / NT);
  brick_conv_kernel<NT><<<grid, NTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)vol, (const float*)w, (float*)out, x, y, z, cs,
      cin, cout, mirror);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// vol bf16 [b, x + 2, y + 2, z + 2, cs] (cs a multiple of 16, >= cin;
// 16-byte aligned), w fp32 [27, cin, cout] ([27, cout, cin], the
// forward's weight, when mirror != 0), out fp32 [b, x, y, z, cout].
extern "C" int brick_conv_forward(const void* vol, const void* w, void* out,
                                  int b, int x, int y, int z, int cs, int cin,
                                  int cout, int mirror, void* stream) {
  if (b < 1 || x < 1 || y < 1 || z < 1 || cin < 1 || cout < 1 ||
      cs % CK != 0 || cin > cs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cout <= 16) return launch<16>(vol, w, out, b, x, y, z, cs, cin, cout, mirror, s);
  if (cout <= 32) return launch<32>(vol, w, out, b, x, y, z, cs, cin, cout, mirror, s);
  return launch<64>(vol, w, out, b, x, y, z, cs, cin, cout, mirror, s);
}

extern "C" const char* brick_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
