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

}  // namespace brick
