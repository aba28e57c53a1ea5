// Dense-volume (brick) conv weight gradient (dW) for Hopper (sm_90a):
// bf16 tensor-core GEMM with fp32 accumulation.
//
// Replaces the TPU kernel `ops/vol_conv.py::vol_conv_dw` (`_dw_kernel`,
// Pallas `pallas_call`) of the JAX package, the dW half of the brick
// route's backward (`_brick_bwd`):
//   dW[k, Cin, Cout] = sum_p bf16(vol[p + delta_k])^T . bf16(g[p])
// over the interior cells p, from the forward's padded input volume and
// the padded cotangent volume that the dF pass also reads
// (`brick_common.cuh`), fp32 result.
//
// What bounds it on the H100: 2 * 27 * cells * Cin * Cout operations
// (operation bound at 128 -> 128) against reading both volumes once.  The
// TPU kernel accumulates one VMEM block across a sequential grid; Hopper's
// blocks run in no order.  So a block takes one 16-wide Cin chunk, one
// NT-wide Cout tile and all 27 taps, walks a run of tiles, and adds its
// partial sums once with fp32 atomicAdd into the zeroed output (the order
// of the fp32 sum over blocks varies from run to run).  A tile whose
// cotangent is all zero (most tiles of a sparse octree level) is skipped
// after its load.  What it does not do yet: the cotangent tile is
// re-read for every Cin chunk, loads are not pipelined (no cp.async/TMA,
// no wgmma) -- later work.
//
// Blocks: 288 threads, nine warps; warp w owns the taps (dx, dy) =
// (w / 3, w % 3), dz = 0..2, as 3 x NT/16 wmma accumulators of 16 Cin
// rows x 16 Cout columns.  Per z-run of 16 cells the cotangent rows are
// the B operand, read once for the three taps; the shifted halo rows,
// read column-major, are A^T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "brick_common.cuh"

namespace {

using namespace nvcuda;
using namespace brick;

constexpr int NWARPS = 9;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CELLS = TX * TY * TZ;  // output cells of a tile
constexpr int TARGET_BLOCKS = 792;   // 6 blocks on each of 132 SMs

template <int NT>
struct Layout {
  static constexpr int LDG = NT + 8;  // bf16, a multiple of 8 for wmma
  static constexpr size_t halo = (size_t)HALO * CK * 2;
  static constexpr size_t grad = (size_t)CELLS * LDG * 2;
  static constexpr size_t stage = (size_t)NWARPS * 256 * 4;
  static constexpr size_t bytes = halo + grad + stage;
};

template <int NT>
__global__ void __launch_bounds__(NTHREADS) brick_conv_dw_kernel(
    const __nv_bfloat16* __restrict__ vol,
    const __nv_bfloat16* __restrict__ gvol, float* __restrict__ dw, int x,
    int y, int z, int cs, int gs, int cin, int cout, int tiles,
    int tiles_per_split) {
  constexpr int LDG = Layout<NT>::LDG, NF = NT / 16, NV = NT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sH = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sH + HALO * CK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* sC = reinterpret_cast<float*>(sG + CELLS * LDG) + warp * 256;
  const int n_co = (cout + NT - 1) / NT;
  const int ci0 = (blockIdx.x / n_co) * CK, co0 = (blockIdx.x % n_co) * NT;
  const int dx = warp / 3, dy = warp % 3;
  const int t_end = min(tiles, (blockIdx.y + 1) * tiles_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][NF];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[d][j], 0.0f);

  bool touched = false;  // block-uniform
  for (int t = blockIdx.y * tiles_per_split; t < t_end; ++t) {
    const Tile o = tile_origin(t, x, y, z);
    __syncthreads();  // every warp is done with the previous tile
    // the tile's cotangent, channels [co0, co0 + NT), 8 a thread; zero
    // past the volume and past its channels
    bool nz = false;
    for (int e = tid; e < CELLS * NV; e += NTHREADS) {
      const int v8 = e % NV, cell = e / NV;
      const int gz = o.z0 + cell % TZ, gy = o.y0 + (cell / TZ) % TY;
      const int gx = o.x0 + cell / (TZ * TY), c = co0 + v8 * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gx < x && gy < y && gz < z && c < gs)
        v = __ldg(reinterpret_cast<const uint4*>(
            gvol + padded_cell(o.b, gx + 1, gy + 1, gz + 1, x, y, z) * gs + c));
      nz |= (v.x | v.y | v.z | v.w) != 0u;
      *reinterpret_cast<uint4*>(sG + cell * LDG + v8 * 8) = v;
    }
    if (!__syncthreads_or(nz)) continue;  // a zero cotangent adds nothing
    touched = true;
    load_halo(sH, vol, o, ci0, x, y, z, cs, tid, NTHREADS);
    __syncthreads();
    for (int run = 0; run < RUNS; ++run) {
      const int rx = run / TY, ry = run % TY;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j)
        wmma::load_matrix_sync(fb[j], sG + run * TZ * LDG + j * 16, LDG);
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        // A^T: 16 channels x 16 shifted cells, the halo read column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
        wmma::load_matrix_sync(
            fa, sH + (((rx + dx) * HY + ry + dy) * HZ + dz) * CK, CK);
#pragma unroll
        for (int j = 0; j < NF; ++j)
          wmma::mma_sync(acc[dz][j], fa, fb[j], acc[dz][j]);
      }
    }
  }
  if (!touched) return;

#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    const int k = (dx * 3 + dy) * 3 + dz;
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(sC, acc[dz][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int ci = ci0 + e / 16, co = co0 + j * 16 + e % 16;
        if (ci < cin && co < cout)
          atomicAdd(dw + ((size_t)k * cin + ci) * cout + co, sC[e]);
      }
      __syncwarp();
    }
  }
}

template <int NT>
int launch(const void* vol, const void* gvol, void* dw, int b, int x, int y,
           int z, int cs, int gs, int cin, int cout, cudaStream_t stream) {
  const size_t smem = Layout<NT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      brick_conv_dw_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = n_tiles(b, x, y, z);
  const int cols = ((cin + CK - 1) / CK) * ((cout + NT - 1) / NT);
  int splits = (TARGET_BLOCKS + cols - 1) / cols;
  splits = splits < 1 ? 1 : (splits > tiles ? tiles : splits);
  const int tiles_per_split = (tiles + splits - 1) / splits;
  splits = (tiles + tiles_per_split - 1) / tiles_per_split;
  brick_conv_dw_kernel<NT><<<dim3(cols, splits), NTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)vol, (const __nv_bfloat16*)gvol, (float*)dw, x, y,
      z, cs, gs, cin, cout, tiles, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() right after the launch.
// vol bf16 [b, x + 2, y + 2, z + 2, cs] (the forward's input), gvol bf16
// [b, x + 2, y + 2, z + 2, gs] (the cotangent, read at the interior), cs
// and gs multiples of 16 with cin <= cs and cout <= gs; dw fp32
// [27, cin, cout] must be zeroed by the caller.
extern "C" int brick_conv_dkernel(const void* vol, const void* gvol, void* dw,
                                  int b, int x, int y, int z, int cs, int gs,
                                  int cin, int cout, void* stream) {
  if (b < 1 || x < 1 || y < 1 || z < 1 || cin < 1 || cout < 1 ||
      cs % CK != 0 || gs % CK != 0 || cin > cs || cout > gs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cout <= 16) return launch<16>(vol, gvol, dw, b, x, y, z, cs, gs, cin, cout, s);
  if (cout <= 32) return launch<32>(vol, gvol, dw, b, x, y, z, cs, gs, cin, cout, s);
  return launch<64>(vol, gvol, dw, b, x, y, z, cs, gs, cin, cout, s);
}

extern "C" const char* brick_conv_dw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
