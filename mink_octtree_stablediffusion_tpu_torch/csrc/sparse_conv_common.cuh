// Geometry and neighbour search shared by the fused sparse-conv kernels
// (`fused_sparse_conv.cu`: forward and dF; `fused_sparse_conv_dw.cu`: dW).
//
// For output row j (batch b, coordinates x) and kernel offset k the query
// q = x + delta_k must lie on the input lattice (q - floor(q / s) * s == 0)
// and inside the extent, and row j must be valid; its int32 flat key
// b*prod(cells) + row-major(q / s) is then binary-searched in the sorted
// input keys (`flat_cell_key`).  The match rule is the JAX package's
// (`ops/onehot_conv.py::_fused_impl`).

#pragma once

#include <cuda_runtime.h>

namespace sparse_conv {

constexpr int MAX_K = 125;  // up to a 5x5x5 cube

struct Geom {
  int k;               // number of offsets
  int s_in[3];         // searched lattice stride
  int cells[3];        // searched lattice cells per axis
  int offs[MAX_K * 3]; // absolute offsets (sign applied for transposes)
};

inline Geom make_geom(int k, const int* offs, const int* s_in,
                      const int* cells) {
  Geom g;
  g.k = k;
  for (int d = 0; d < 3; ++d) {
    g.s_in[d] = s_in[d];
    g.cells[d] = cells[d];
  }
  for (int i = 0; i < k * 3; ++i) g.offs[i] = offs[i];
  return g;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Input row matching output row `coord` (batch, x, y, z; batch < 0 marks an
// invalid row) shifted by offset k, or -1.
__device__ __forceinline__ int find_neighbor(const int coord[4], int k,
                                             const Geom& g,
                                             const int* __restrict__ in_keys,
                                             int n_in) {
  if (coord[0] < 0) return -1;
  int key = coord[0];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int q = coord[1 + d] + g.offs[k * 3 + d];
    const int p = floor_div(q, g.s_in[d]);
    if (q != p * g.s_in[d] || p < 0 || p >= g.cells[d]) return -1;
    key = key * g.cells[d] + p;
  }
  int lo = 0, hi = n_in;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(in_keys + mid) < key) lo = mid + 1; else hi = mid;
  }
  return (lo < n_in && __ldg(in_keys + lo) == key) ? lo : -1;
}

// Loads output row r's coordinates into c (batch -1 if r is past the end
// or invalid).
__device__ __forceinline__ void load_coord(int c[4], int r, int n_out,
                                           const int* __restrict__ out_coords,
                                           const unsigned char* __restrict__ out_valid) {
  if (r < n_out && out_valid[r]) {
    for (int d = 0; d < 4; ++d) c[d] = out_coords[(size_t)r * 4 + d];
  } else {
    c[0] = -1;
  }
}

}  // namespace sparse_conv
