// Host-side voxelization, dedup, label consensus, Morton codes and batch
// collation for the data pipeline, behind a plain C interface loaded with
// ctypes (`native/__init__.py`).
//
// The port's own copy of the JAX package's `native/voxelize.cpp`, the
// counterpart of the reference's native quantization path
// (`src/quantization.cpp`, `pybind/extern.hpp:471-483`: quantize_np /
// quantize_label_np) and the hot parts of its data pipeline
// (`MinkowskiEngine/utils/quantization.py:68-122`, `utils/collation.py`).
// This is host code: it feeds the device, and runs on no device.
//
// Built at first use by `native/build.py`:
//   g++ -O3 -march=native -shared -fPIC voxelize.cpp -o libvoxelize_<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// 64-bit FNV-1a over the raw bytes of a voxel key — the same family the
// reference uses for coordinate hashing (`utils/quantization.py:32-46`).
inline uint64_t fnv1a(const int32_t* v, int d) {
  uint64_t h = 14695981039346656037ull;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(v);
  for (int i = 0; i < d * 4; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

struct HashTable {
  // open addressing, power-of-two size, row index payload
  std::vector<int64_t> slot;  // -1 empty, else row id of first occurrence
  uint64_t mask;
  explicit HashTable(int64_t n) {
    uint64_t size = 16;
    while (size < static_cast<uint64_t>(2 * n)) size <<= 1;
    slot.assign(size, -1);
    mask = size - 1;
  }
};

}  // namespace

extern "C" {

// Voxelize continuous points and dedup (first occurrence wins).
//   pts        [n, d] float32 (continuous coordinates)
//   qsize      quantization size (voxel edge)
//   out_coords [n, d] int32 — unique voxel coords, first-occurrence order
//   out_inverse[n] int32 — input row -> unique row
//   returns number of unique voxels
// Parity: `utils/quantization.py:68-122` (quantize) +
// `MinkowskiSparseTensor.py:293-345` first-occurrence semantics.
int64_t voxelize_unique(const float* pts, int64_t n, int32_t d, float qsize,
                        int32_t* out_coords, int32_t* out_inverse) {
  if (n == 0) return 0;
  std::vector<int32_t> vox(static_cast<size_t>(n) * d);
  const float inv = 1.0f / qsize;
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t j = 0; j < d; ++j) {
      float v = pts[i * d + j] * inv;
      // floor semantics (matches np.floor-based reference quantization)
      int32_t q = static_cast<int32_t>(v);
      if (v < 0 && v != static_cast<float>(q)) --q;
      vox[i * d + j] = q;
    }
  }
  HashTable table(n);
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* key = &vox[i * d];
    uint64_t h = fnv1a(key, d) & table.mask;
    for (;;) {
      int64_t occ = table.slot[h];
      if (occ < 0) {
        table.slot[h] = n_unique;
        std::memcpy(out_coords + n_unique * d, key, d * 4);
        out_inverse[i] = static_cast<int32_t>(n_unique);
        ++n_unique;
        break;
      }
      if (std::memcmp(out_coords + occ * d, key, d * 4) == 0) {
        out_inverse[i] = static_cast<int32_t>(occ);
        break;
      }
      h = (h + 1) & table.mask;
    }
  }
  return n_unique;
}

// Unique over already-integer batched coords; same contract as above.
// Parity: native `quantize_np` (`pybind/extern.hpp:473-475`).
int64_t unique_coords(const int32_t* coords, int64_t n, int32_t d,
                      int32_t* out_coords, int32_t* out_inverse) {
  if (n == 0) return 0;
  HashTable table(n);
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* key = coords + i * d;
    uint64_t h = fnv1a(key, d) & table.mask;
    for (;;) {
      int64_t occ = table.slot[h];
      if (occ < 0) {
        table.slot[h] = n_unique;
        std::memcpy(out_coords + n_unique * d, key, d * 4);
        out_inverse[i] = static_cast<int32_t>(n_unique);
        ++n_unique;
        break;
      }
      if (std::memcmp(out_coords + occ * d, key, d * 4) == 0) {
        out_inverse[i] = static_cast<int32_t>(occ);
        break;
      }
      h = (h + 1) & table.mask;
    }
  }
  return n_unique;
}

// Label-consensus quantization: unique voxels keep their label when all
// merged points agree, else `invalid_label`.
// Parity: native `quantize_label_np` (`pybind/extern.hpp:477-479`,
// `utils/quantization.py:96-122`).
int64_t unique_coords_label(const int32_t* coords, const int32_t* labels,
                            int64_t n, int32_t d, int32_t invalid_label,
                            int32_t* out_coords, int32_t* out_labels,
                            int32_t* out_inverse) {
  if (n == 0) return 0;
  HashTable table(n);
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* key = coords + i * d;
    uint64_t h = fnv1a(key, d) & table.mask;
    for (;;) {
      int64_t occ = table.slot[h];
      if (occ < 0) {
        table.slot[h] = n_unique;
        std::memcpy(out_coords + n_unique * d, key, d * 4);
        out_labels[n_unique] = labels[i];
        out_inverse[i] = static_cast<int32_t>(n_unique);
        ++n_unique;
        break;
      }
      if (std::memcmp(out_coords + occ * d, key, d * 4) == 0) {
        if (out_labels[occ] != labels[i]) out_labels[occ] = invalid_label;
        out_inverse[i] = static_cast<int32_t>(occ);
        break;
      }
      h = (h + 1) & table.mask;
    }
  }
  return n_unique;
}

// 30-bit Morton code (10 bits/dim, offset 512) of stride-normalized coords —
// byte-compatible with ops/morton.py `morton_encode_np`.
void morton_codes(const int32_t* xyz, int64_t n, int32_t d, int32_t stride,
                  int32_t* out) {
  const int bits = 30 / d;
  const int32_t half = 1 << (bits - 1);
  const int32_t maxv = (1 << bits) - 1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t code = 0;
    for (int32_t dim = 0; dim < d; ++dim) {
      int32_t c = xyz[i * d + dim];
      int32_t q = (c >= 0 ? c / stride : -((-c + stride - 1) / stride)) + half;
      if (q < 0) q = 0;
      if (q > maxv) q = maxv;
      for (int b = 0; b < bits; ++b) {
        code |= static_cast<int64_t>((q >> b) & 1) << (b * d + (d - 1 - dim));
      }
    }
    out[i] = static_cast<int32_t>(code);
  }
}

// Fused collation: batched voxelize+dedup of B point clouds into one
// fixed-capacity buffer (batch column prepended, padding rows filled with
// `pad_value`), returning the total row count actually written.
// Parity: `utils/collation.py:30-92` + `ops/coords.py pad_to_capacity`.
int64_t collate_batch(const float* pts, const int64_t* offsets, int32_t b,
                      int32_t d, float qsize, int64_t capacity,
                      int32_t pad_value, int32_t* out_coords,
                      uint8_t* out_valid) {
  int64_t row = 0;
  std::vector<int32_t> tmp_coords;
  std::vector<int32_t> tmp_inverse;
  for (int32_t bi = 0; bi < b && row < capacity; ++bi) {
    int64_t n = offsets[bi + 1] - offsets[bi];
    tmp_coords.assign(static_cast<size_t>(n) * d, 0);
    tmp_inverse.assign(static_cast<size_t>(n), 0);
    int64_t nu = voxelize_unique(pts + offsets[bi] * d, n, d, qsize,
                                 tmp_coords.data(), tmp_inverse.data());
    for (int64_t i = 0; i < nu && row < capacity; ++i, ++row) {
      out_coords[row * (d + 1)] = bi;
      std::memcpy(out_coords + row * (d + 1) + 1, &tmp_coords[i * d], d * 4);
      out_valid[row] = 1;
    }
  }
  for (int64_t r = row; r < capacity; ++r) {
    for (int32_t j = 0; j <= d; ++j) out_coords[r * (d + 1) + j] = pad_value;
    out_valid[r] = 0;
  }
  return row;
}

}  // extern "C"
