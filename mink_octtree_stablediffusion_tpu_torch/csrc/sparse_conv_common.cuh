// Geometry and neighbour search shared by the fused sparse-conv kernels
// (`fused_sparse_conv.cu`: forward and dF; `fused_sparse_conv_dw.cu`: dW).
//
// For output row j (batch b, coordinates x) and kernel offset k the query
// q = x + delta_k must lie on the input lattice (q - floor(q / s) * s == 0)
// and inside the extent, and row j must be valid; its int32 flat key
// b*prod(cells) + row-major(q / s) is then binary-searched in the sorted
// input keys (`flat_cell_key`).  The match rule is the JAX package's
// (`ops/onehot_conv.py::_fused_impl`), which holds for grids of any D; the
// kernels take D = 2 or 3 (`ndim`): a coordinate row is (batch, x_1..x_D),
// 1 + D ints, and the offsets, strides and cells have D entries each.

#pragma once

#include <cuda_runtime.h>

namespace sparse_conv {

// Up to a 5x5x5 cube: the geometry is a by-value kernel parameter holding
// MAX_K * MAX_D offsets, and the forward keeps K x 128 match indices in shared
// memory (64 KB at K = 125).
constexpr int MAX_K = 125;
constexpr int MAX_D = 3;

struct Geom {
  int k;                   // number of offsets
  int ndim;                // D, 2 or 3
  int s_in[MAX_D];         // searched lattice stride
  int cells[MAX_D];        // searched lattice cells per axis
  int offs[MAX_K * MAX_D]; // absolute offsets (sign applied for
                           // transposes), offset k's at k * MAX_D
};

// offs [k * ndim], s_in [ndim] and cells [ndim] are host arrays.
inline Geom make_geom(int k, int ndim, const int* offs, const int* s_in,
                      const int* cells) {
  Geom g = {};
  g.k = k;
  g.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    g.s_in[d] = s_in[d];
    g.cells[d] = cells[d];
  }
  for (int i = 0; i < k; ++i)
    for (int d = 0; d < ndim; ++d) g.offs[i * MAX_D + d] = offs[i * ndim + d];
  return g;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// A grid's D as a type, for the searches' one branch on `Geom::ndim`.
template <int N>
struct Dim {
  static constexpr int value = N;
};

// Input row matching output row `coord` (batch, x_1..x_ND; batch < 0 marks
// an invalid row) shifted by offset k, or -1.  ND is `g.ndim`, a template
// parameter so that each D's search is a fixed loop over its axes: the
// callers branch once on `g.ndim` (uniform over a launch).
template <int ND>
__device__ __forceinline__ int find_neighbor(const int coord[1 + MAX_D],
                                             int k, const Geom& g,
                                             const int* __restrict__ in_keys,
                                             int n_in) {
  if (coord[0] < 0) return -1;
  int key = coord[0];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int q = coord[1 + d] + g.offs[k * MAX_D + d];
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

// The valid keys of a sorted key array whose padding rows hold INT32_MAX
// (they sort last): the index of the first INT32_MAX.  One thread's
// binary search, for the work a launch counts (`work`, see the kernels).
__device__ __forceinline__ int count_valid_keys(const int* __restrict__ keys,
                                                int n) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < 0x7fffffff) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Loads output row r's coordinates (a row of 1 + ND ints) into c (batch
// -1 if r is past the end or invalid).
template <int ND>
__device__ __forceinline__ void load_coord(int c[1 + MAX_D], int r, int n_out,
                                           const int* __restrict__ out_coords,
                                           const unsigned char* __restrict__ out_valid) {
  if (r < n_out && out_valid[r]) {
#pragma unroll
    for (int d = 0; d <= ND; ++d) c[d] = out_coords[(size_t)r * (1 + ND) + d];
  } else {
    c[0] = -1;
  }
}

// f(Dim<2>{}) or f(Dim<3>{}) as g.ndim says.
template <typename F>
__device__ __forceinline__ void with_ndim(const Geom& g, F&& f) {
  if (g.ndim == 3) f(Dim<3>{}); else f(Dim<2>{});
}

}  // namespace sparse_conv
