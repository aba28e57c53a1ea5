// Tile geometry and halo loads shared by the dense-volume (brick) conv
// kernels (`brick_conv.cu`: forward and dF; `brick_conv_dw.cu`: dW).
//
// A volume is [b][x + 2][y + 2][z + 2][cs] in bf16: the interior x, y, z
// cells with a 1-cell zero shell on every side and `cs` channels (a
// multiple of 16, channels past the conv's own are zero).  Output cell
// (b, i, j, k) of a k=3 s=1 conv reads padded cells (i + dx, j + dy, k + dz)
// for (dx, dy, dz) in {0, 1, 2}^3, tap index (dx * 3 + dy) * 3 + dz -- the
// C-order over the offsets {-1, 0, 1}^3 of `KernelSpec.offsets`.
//
// A tile is 4 x 4 x 16 output cells (x, y, z): 16 runs of 16 cells along
// z, each run one 16-row MMA operand.  Its halo is 6 x 6 x 18 padded
// cells.  Tiles past the volume's edge are masked by the loads (zeros)
// and by the stores.
//
// Float32 compute: a float32 volume is first split by `split_volume` into
// three bf16 volumes, term u at `u * n` elements (stacked along the
// instance axis, so that they read as one volume of 3b instances), and the
// kernels sum the products of the terms whose indices add up to at most 2
// (`hopper::split`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace brick {

constexpr int TX = 4, TY = 4, TZ = 16;  // output cells of a tile
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int HALO = HX * HY * HZ;  // 648 padded cells
constexpr int RUNS = TX * TY;       // z-runs of TZ = 16 cells
constexpr int CK = 16;              // channels per chunk: the MMA depth

struct Tile {
  int b, x0, y0, z0;
};

__host__ __device__ inline int n_tiles(int b, int x, int y, int z) {
  return b * ((x + TX - 1) / TX) * ((y + TY - 1) / TY) * ((z + TZ - 1) / TZ);
}

__device__ __forceinline__ Tile tile_origin(int t, int x, int y, int z) {
  const int nz = (z + TZ - 1) / TZ, ny = (y + TY - 1) / TY;
  const int nx = (x + TX - 1) / TX;
  Tile o;
  o.z0 = (t % nz) * TZ;
  t /= nz;
  o.y0 = (t % ny) * TY;
  t /= ny;
  o.x0 = (t % nx) * TX;
  o.b = t / nx;
  return o;
}

// Index of padded cell (px, py, pz) of instance b.
__device__ __forceinline__ size_t padded_cell(int b, int px, int py, int pz,
                                              int x, int y, int z) {
  return (((size_t)b * (x + 2) + px) * (y + 2) + py) * (z + 2) + pz;
}

// Term u of the float32 values x[0, n) at out + u * n, u = 0, 1, 2 (n a
// multiple of 4; both 16-byte aligned): the cast pass of the float32
// instantiations, one float4 a thread.  Plain version:
// `ops/fused_conv.py::split_terms`.
__global__ void split_kernel(const float* __restrict__ x,
                             __nv_bfloat16* __restrict__ out, long long n) {
  const long long n4 = n / 4;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n4; e += (long long)gridDim.x * blockDim.x) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + e);
    __nv_bfloat16 t[4][3];
    hopper::split<3>(v.x, t[0]);
    hopper::split<3>(v.y, t[1]);
    hopper::split<3>(v.z, t[2]);
    hopper::split<3>(v.w, t[3]);
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const __nv_bfloat162 lo = __halves2bfloat162(t[0][u], t[1][u]);
      const __nv_bfloat162 hi = __halves2bfloat162(t[2][u], t[3][u]);
      uint2 w;
      w.x = *reinterpret_cast<const uint32_t*>(&lo);
      w.y = *reinterpret_cast<const uint32_t*>(&hi);
      reinterpret_cast<uint2*>(out + u * n)[e] = w;
    }
  }
}

inline int split_volume(const float* x, __nv_bfloat16* out, long long n,
                        cudaStream_t stream) {
  if (n % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n / 4 + 255) / 256;
  split_kernel<<<(int)(blocks < 1 ? 1 : blocks > 8192 ? 8192 : blocks), 256,
                 0, stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// The products of a float32 instantiation: (volume term i, second operand
// term j) with i + j <= 2, i < TA, j < TB, in order (i, then j); `pair`
// gives product p's terms.
template <int TA, int TB>
__host__ __device__ constexpr int n_pairs() {
  int n = 0;
  for (int i = 0; i < TA; ++i)
    for (int j = 0; j < TB; ++j) n += i + j <= 2;
  return n;
}

template <int TA, int TB>
__device__ __forceinline__ void pair(int p, int& ti, int& tj) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      if (i + j <= 2) {
        if (n == p) ti = i, tj = j;
        ++n;
      }
}

}  // namespace brick
