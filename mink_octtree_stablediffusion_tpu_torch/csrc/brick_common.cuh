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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Loads channels [c0, c0 + 16) of the tile's halo into sH[HALO][16] (cell
// (hx * HY + hy) * HZ + hz), 16 bytes a thread; cells past the padded
// volume load zeros.  Returns whether this thread loaded a nonzero bit.
__device__ __forceinline__ bool load_halo(__nv_bfloat16* sH,
                                          const __nv_bfloat16* __restrict__ vol,
                                          const Tile& o, int c0, int x, int y,
                                          int z, int cs, int tid,
                                          int nthreads) {
  bool nz = false;
  for (int e = tid; e < HALO * 2; e += nthreads) {
    const int cell = e >> 1, half = e & 1;
    const int hz = cell % HZ, hy = (cell / HZ) % HY, hx = cell / (HZ * HY);
    const int px = o.x0 + hx, py = o.y0 + hy, pz = o.z0 + hz;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (px < x + 2 && py < y + 2 && pz < z + 2)
      v = __ldg(reinterpret_cast<const uint4*>(
                    vol + padded_cell(o.b, px, py, pz, x, y, z) * cs + c0) +
                half);
    nz |= (v.x | v.y | v.z | v.w) != 0u;
    reinterpret_cast<uint4*>(sH + cell * CK)[half] = v;
  }
  return nz;
}

}  // namespace brick
