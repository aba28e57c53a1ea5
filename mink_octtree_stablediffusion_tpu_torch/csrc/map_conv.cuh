// Sparse conv given a kernel map, for Hopper (sm_90a): the passes shared by
// B4 (`onehot_sparse_conv.cu`) and B7 (`pallas_sparse_conv.cu`).
//
// Both TPU kernels compute, for an arbitrary map nbr int32[K, N_out],
//   out_j = sum_k f[nbr[k, j]] . W_k,   an index outside [0, n_in) adds zero,
// summed in fp32, the output in the features' dtype.  They differ in the
// products: B4 (`ops/onehot_conv.py::onehot_sparse_conv`) rounds both
// operands to bf16 (its `compute_dtype`); B7 (`ops/pallas_conv.py::
// pallas_sparse_conv`) multiplies the features as given by the fp32 weight,
// so its products are fp32-accurate.
//
// What bounds it on the H100: at the library path's widths (3 -> 32 on a
// 26,098-point room, 32 -> 32 on the finest octree level) the bytes (the
// map, the features, the weight and the output once); at 512 -> 512 the
// matched pairs' operations, 2 * pairs * Cin * Cout (0.037 ms at the bf16
// peak on the 16,384-row encoder level, 70,639 pairs).  The first designs
// ran over 100x that: they multiplied whole 64-row tiles of which a third
// or less of the rows had a match, re-read and re-converted the fp32 weight
// box for every row tile and channel chunk, loaded synchronously between
// two products, and B7 ran fp32 as an FMA loop outside the tensor cores.
// This design runs up to seven passes from one host call, on one stream:
//   1. cast (`cast_kernel`): the features to TA bf16 terms [TA][n_in, CinF]
//      and the weight to TB bf16 terms [TB][K, CinW, CoutP] in the MMA's B
//      layout (CinF = Cin rounded up to 8, CinW to the chunk BK, CoutP to
//      the tile BN, zero-filled), once per call.  A value x is split as
//      t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1) (`split`,
//      `hopper_mma.cuh`): three terms hold an fp32 value to about 2^-24 of
//      itself.  Plain versions:
//      `ops/onehot_conv.py::split_terms`, `map_conv_operands`;
//   2. count (`count_kernel`): matches per (offset, block of 256 outputs),
//      a block walking 8 offsets;
//   3. scan (`scan_kernel`, one block, tiles staged in shared memory):
//      their exclusive prefix sum, so that
//      offset k's pairs are off[k * rb] .. off[(k + 1) * rb], and the prefix
//      sum of each offset's 128-pair tiles;
//   4. compaction (`compact_kernel`): offset k's (input row, output row)
//      pairs in ascending output row, as the input rows `pair_in` and the
//      inverse `pos[k][j]` (the pair's index, -1 for none).  Plain version:
//      `map_pair_list`.  No band or order of the map is assumed: shuffled
//      and duplicated columns, offsets with no pair and all-missing maps
//      take the same path;
//   5. GEMM (`gemm_kernel`), one launch per group of offsets: a persistent
//      grid walks (128-pair tile, BN Cout tile) items, each tile inside one
//      offset (one W_k); a ring of 3-6 stages over Cin chunks gathers the
//      pairs' rows with 16-byte `cp.async` into XOR-swizzled tiles and the
//      W_k box likewise (a layer with fewer Cin chunks than stages keeps
//      only as many slots, so more blocks fit an SM), `ldmatrix` +
//      `mma.sync.m16n8k16` (bf16 in, fp32 accumulate) over the term
//      products a_i . b_j with i + j <= 2, and the epilogue writes each
//      pair's fp32 partial row.  The GEMM's depth
//      is exactly the matched pairs (rounded up to 128 per offset);
//   6. reduce (`reduce_kernel`), after each group's GEMM: every output row
//      adds its partials (8 offsets' loads in flight at a time) in offset
//      order to its running fp32 sum (held
//      between groups in `acc`), and the last group writes the output in
//      the features' dtype.  No atomics: two launches give the same output
//      bit for bit.  Groups bound the partials: G offsets of at most N_out
//      pairs each, G * N_out * Cout * 4 bytes (`ops/onehot_conv.py::
//      map_groups`); the pair counts are known only on the device.
// The products, a template parameter (TA, TB):
//   - B4: (1, 1), one bf16 product, as the TPU kernel;
//   - B7 on bf16 features: (1, 3), the features exact in one term times the
//     weight's three: 3 products, an fp32-accurate weight;
//   - B7 on fp32 features: (3, 3), the 6 products with i + j <= 2 (the
//     dropped ones are below 2^-24 of the result).
//   3xTF32 (`mma...tf32`, a hi/lo split, 3 products) would take as long for
//   fp32 features (495 TFLOP/s TF32 against 989 bf16: 3/495 = 6/989) but
//   longer for bf16 features (2 TF32 products against 3 bf16), and needs a
//   second mainloop with 32-bit fragments; one bf16 mainloop serves all.
// What is left: each gathered row is re-read for each Cout tile (from L2);
// the partials make a round trip through memory (0.29 GB on the 512 -> 512
// level); a warp-specialised producer and `wgmma` are later work.
//
// Stages (`stage`): kFull runs every pass; kCast stops after the cast and
// kPairs after the compaction, so that the card tests can hold each pass
// against its plain version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

// A named namespace: a profile finds every pass by "map_conv::".
namespace map_conv {

using namespace hopper;

constexpr int BM = 128;       // pairs of a GEMM tile
constexpr int NTHREADS = 256;  // a GEMM block
constexpr int ROWS = 256;      // output rows of a count or compaction block
constexpr int KB = 8;          // offsets of a count or compaction block
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;  // a scan thread's values of one tile
constexpr int RB = 8;          // partials a reduce thread has in flight
constexpr int MAX_K = 65535;  // offsets

enum Stage { kFull = 0, kCast = 1, kPairs = 2 };

struct Args {
  const void* feat;
  int feat_bf16;
  const void* w;
  int w_bf16;
  const int* nbr;
  void* out;  // the features' dtype
  __nv_bfloat16 *fb, *wb;
  int *cnt, *off, *tile_off, *pair_in, *pos;
  float *part, *acc;
  int n_in, n_out, cin, cout, k, bn, bk, group, stage;
};

__device__ __forceinline__ float load_val(const void* p, int is_bf16,
                                          size_t i) {
  return is_bf16
             ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

// -- 1. cast -----------------------------------------------------------------

// feat [n_in, cin] -> fb [TA][n_in, cinf]; w [k, cin, cout] -> wb [TB][k,
// cinw, coutp]; zero past the widths; one thread per 8 values.
template <int TA, int TB>
__global__ void cast_kernel(const void* __restrict__ feat, int feat_bf16,
                            const void* __restrict__ w, int w_bf16,
                            __nv_bfloat16* __restrict__ fb,
                            __nv_bfloat16* __restrict__ wb, int n_in, int cin,
                            int cinf, int k, int cout, int cinw, int coutp) {
  const long long fcpr = cinf / 8, wcpr = coutp / 8;
  const long long nf = (long long)n_in * fcpr;
  const long long total = nf + (long long)k * cinw * wcpr;
  const size_t fterm = (size_t)n_in * cinf, wterm = (size_t)k * cinw * coutp;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (e < nf) {
      const long long r = e / fcpr;
      const int c = (int)(e - r * fcpr) * 8;
      uint4 pack[TA];
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(pack);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        __nv_bfloat16 t[TA];
        split(c + u < cin ? load_val(feat, feat_bf16, r * cin + c + u) : 0.0f,
              t);
#pragma unroll
        for (int a = 0; a < TA; ++a) v[a * 8 + u] = t[a];
      }
#pragma unroll
      for (int a = 0; a < TA; ++a)
        *reinterpret_cast<uint4*>(fb + a * fterm + r * cinf + c) = pack[a];
    } else {
      const long long row = (e - nf) / wcpr;  // o * cinw + i
      const int c = (int)(e - nf - row * wcpr) * 8;
      const long long o = row / cinw;
      const int i = (int)(row - o * cinw);
      uint4 pack[TB];
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(pack);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        __nv_bfloat16 t[TB];
        split(i < cin && c + u < cout
                  ? load_val(w, w_bf16, (o * cin + i) * cout + c + u)
                  : 0.0f,
              t);
#pragma unroll
        for (int b = 0; b < TB; ++b) v[b * 8 + u] = t[b];
      }
#pragma unroll
      for (int b = 0; b < TB; ++b)
        *reinterpret_cast<uint4*>(wb + b * wterm + row * coutp + c) = pack[b];
    }
  }
}

// -- 2. count ----------------------------------------------------------------

// Block (row block t, offsets KB * y ..): cnt[k][t] = the row block's
// outputs with a match for offset k.
__global__ void __launch_bounds__(ROWS) count_kernel(
    const int* __restrict__ nbr, int* __restrict__ cnt, int n_in, int n_out,
    int k) {
  const int t = blockIdx.x, j = t * ROWS + threadIdx.x;
  const int k1 = min(k, (blockIdx.y + 1) * KB);
  for (int kk = blockIdx.y * KB; kk < k1; ++kk) {
    const int v = j < n_out ? __ldg(nbr + (size_t)kk * n_out + j) : -1;
    const int n = __syncthreads_count(v >= 0 && v < n_in);
    if (threadIdx.x == 0) cnt[kk * gridDim.x + t] = n;
  }
}

// -- 3. scan -----------------------------------------------------------------

// put(i, sum of get(0..i)) for i in [0, m], in one block of SCAN_THREADS,
// a tile of SCAN_THREADS * SCAN_ITEMS values at a time: the tile is read
// into shared memory with coalesced loads, each thread sums its SCAN_ITEMS
// consecutive values, the sums are scanned across the block, and the
// results are written with coalesced stores, carried from tile to tile.
template <class Get, class Put>
__device__ void scan_runs(int m, Get get, Put put, int* warp_sum,
                          int* tile) {
  constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int t0 = 0; t0 < m; t0 += TILE) {
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS; ++u) {
      const int i = t0 + u * SCAN_THREADS + tid;
      tile[u * SCAN_THREADS + tid] = i < m ? get(i) : 0;
    }
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS; ++u) s += tile[tid * SCAN_ITEMS + u];
    int x = s;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int ws = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, ws, d);
        if (lane >= d) ws += y;
      }
      warp_sum[lane] = ws;
    }
    __syncthreads();
    int run = carry + x - s + (warp ? warp_sum[warp - 1] : 0);
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS; ++u) {  // exclusive, in place
      const int g = tile[tid * SCAN_ITEMS + u];
      tile[tid * SCAN_ITEMS + u] = run;
      run += g;
    }
    carry += warp_sum[SCAN_THREADS / 32 - 1];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < SCAN_ITEMS; ++u) {
      const int i = t0 + u * SCAN_THREADS + tid;
      if (i < m) put(i, tile[u * SCAN_THREADS + tid]);
    }
    __syncthreads();  // the tile and warp_sum are free again
  }
  if (tid == 0) put(m, carry);
  __syncthreads();  // every put is visible
}

// off[e] = sum of cnt[0..e) for e in [0, k * rb]; tile_off[k'] = the
// 128-pair tiles of offsets 0..k'-1, for k' in [0, k].
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(
    const int* __restrict__ cnt, int* __restrict__ off,
    int* __restrict__ tile_off, int rb, int k) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  __shared__ int tile[SCAN_THREADS * SCAN_ITEMS];
  scan_runs(
      k * rb, [&](int i) { return cnt[i]; },
      [&](int i, int v) { off[i] = v; }, warp_sum, tile);
  scan_runs(
      k,
      [&](int i) { return (off[(i + 1) * rb] - off[i * rb] + BM - 1) / BM; },
      [&](int i, int v) { tile_off[i] = v; }, warp_sum, tile);
}

// -- 4. compaction -----------------------------------------------------------

// Block (row block t, offsets KB * y ..): for each offset k, the row
// block's matched outputs' pairs at off[k][t] onwards, in ascending output
// row: pair_in[q] = the input row, and pos[k][j] = q (-1 where output j
// has no match for offset k).
__global__ void __launch_bounds__(ROWS) compact_kernel(
    const int* __restrict__ nbr, const int* __restrict__ off,
    int* __restrict__ pair_in, int* __restrict__ pos, int n_in, int n_out,
    int k) {
  __shared__ int warp_n[2][ROWS / 32];  // by offset parity: one barrier each
  const int t = blockIdx.x, j = t * ROWS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k1 = min(k, (blockIdx.y + 1) * KB);
  for (int kk = blockIdx.y * KB; kk < k1; ++kk) {
    int* wn = warp_n[kk & 1];
    const int v = j < n_out ? __ldg(nbr + (size_t)kk * n_out + j) : -1;
    const bool hit = v >= 0 && v < n_in;
    const unsigned ball = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wn[warp] = __popc(ball);
    __syncthreads();
    int q = -1;
    if (hit) {
      q = off[kk * gridDim.x + t] + __popc(ball & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) q += wn[w];
      pair_in[q] = v;
    }
    if (j < n_out) pos[(size_t)kk * n_out + j] = q;
  }
}

// -- 5. GEMM -----------------------------------------------------------------

template <int BN, int BK, int TA, int TB>
struct Cfg {
  static constexpr int A_ELEMS = BM * BK;  // one term's gathered rows
  static constexpr int B_ELEMS = BK * BN;  // one term's W_k box
  static constexpr int STAGE_ELEMS = TA * A_ELEMS + TB * B_ELEMS;
  static constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
  static constexpr int STAGES =
      STAGE_BYTES > 24576 ? 3 : STAGE_BYTES > 16384 ? 4 : 6;
  static constexpr int IDX_BYTES = BM * 4;  // the tile's rows, first
  // dynamic shared memory: the rows and the ring, of which a launch whose
  // Cin chunks are fewer than the stages uses only as many slots
  static constexpr int smem(int nch) {
    return IDX_BYTES + (nch < STAGES ? nch : STAGES) * STAGE_BYTES;
  }
};

// Items (tile t of the group's offsets k0..k1-1, Cout tile): part[q - base]
// = sum over the term pairs (a, b), a + b <= 2, of fb[a][pair_in[q]] .
// wb[b][k] over the tile's pairs q, base = offset k0's first pair.
template <int BN, int BK, int TA, int TB>
__global__ void __launch_bounds__(NTHREADS, 2) gemm_kernel(
    const __nv_bfloat16* __restrict__ fb,
    const __nv_bfloat16* __restrict__ wb, const int* __restrict__ pair_in,
    const int* __restrict__ off, const int* __restrict__ tile_off,
    float* __restrict__ part, int n_in, int cinf, int cinw, int cout,
    int coutp, int k, int rb, int k0, int k1) {
  using C = Cfg<BN, BK, TA, TB>;
  constexpr int STAGES = C::STAGES;
  constexpr int WCOLS = BN / 2;  // a warp's columns
  constexpr int NF = WCOLS / 8;  // its n8 tiles
  extern __shared__ __align__(128) unsigned char smem[];
  int* sIdx = reinterpret_cast<int*>(smem);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + C::IDX_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;  // 4 x 2 warps of 32 x WCOLS
  const size_t fterm = (size_t)n_in * cinf, wterm = (size_t)k * cinw * coutp;
  const int ntn = (cout + BN - 1) / BN, nch = cinw / BK;
  const int t0 = tile_off[k0], total = (tile_off[k1] - t0) * ntn;
  const int base = off[k0 * rb];

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const int t = t0 + item / ntn, n0 = (item % ntn) * BN;
    int lo = k0, hi = k1 - 1;  // the offset whose tiles hold t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tile_off[mid] <= t) lo = mid; else hi = mid - 1;
    }
    const int kk = lo;
    const int q0 = off[kk * rb] + (t - tile_off[kk]) * BM;
    const int q1 = min(q0 + BM, off[(kk + 1) * rb]);
    if (tid < BM) sIdx[tid] = q0 + tid < q1 ? __ldg(pair_in + q0 + tid) : -1;
    __syncthreads();

    // step s: Cin chunk s of every term's rows and W_k box, as one cp.async
    // group (empty past the last); a row past the tile or a channel past
    // CinF is zero
    auto load_step = [&](int s) {
      if (s < nch) {
        const int c0 = s * BK;
        __nv_bfloat16* sA = ring + (s % STAGES) * C::STAGE_ELEMS;
        __nv_bfloat16* sB = sA + TA * C::A_ELEMS;
        for (int e = tid; e < BM * (BK / 8); e += NTHREADS) {
          const int row = e / (BK / 8), seg = e % (BK / 8);
          const int src = sIdx[row], ch = c0 + seg * 8;
          const bool ok = src >= 0 && ch < cinf;
          const uint32_t dst =
              smem_u32(sA + row * BK + swizzle<BK / 8>(row, seg) * 8);
          const size_t so = ok ? (size_t)src * cinf + ch : 0;
#pragma unroll
          for (int a = 0; a < TA; ++a)
            cp_async16(dst + a * C::A_ELEMS * 2, fb + a * fterm + so,
                       ok ? 16 : 0);
        }
        const __nv_bfloat16* wk = wb + ((size_t)kk * cinw + c0) * coutp + n0;
        for (int e = tid; e < BK * (BN / 8); e += NTHREADS) {
          const int kr = e / (BN / 8), seg = e % (BN / 8);
          const uint32_t dst =
              smem_u32(sB + kr * BN + swizzle<BN / 8>(kr, seg) * 8);
#pragma unroll
          for (int b = 0; b < TB; ++b)
            cp_async16(dst + b * C::B_ELEMS * 2,
                       wk + b * wterm + (size_t)kr * coutp + seg * 8, 16);
        }
      }
      cp_async_commit();
    };

    float acc[2][NF][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) load_step(s);
    for (int s = 0; s < nch; ++s) {
      cp_async_wait<STAGES - 2>();  // step s has landed ...
      __syncthreads();  // ... for every thread; slot (s - 1) % STAGES is free
      load_step(s + STAGES - 1);
      const __nv_bfloat16* sA = ring + (s % STAGES) * C::STAGE_ELEMS;
      const __nv_bfloat16* sB = sA + TA * C::A_ELEMS;
#pragma unroll
      for (int kq = 0; kq < BK / 16; ++kq) {
        uint32_t a[TA][2][4];
#pragma unroll
        for (int ta = 0; ta < TA; ++ta)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int row = wm * 32 + mi * 16 + (lane & 15);
            ldmatrix_x4(a[ta][mi],
                        smem_u32(sA + ta * C::A_ELEMS + row * BK +
                                 swizzle<BK / 8>(row, kq * 2 + (lane >> 4)) * 8));
          }
        const int krow = kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int jp = 0; jp < NF / 2; ++jp) {
          const int chunk = (wn * WCOLS + jp * 16) / 8 + (lane >> 4);
          uint32_t b[TB][4];
#pragma unroll
          for (int tb = 0; tb < TB; ++tb)
            ldmatrix_x4_trans(
                b[tb], smem_u32(sB + tb * C::B_ELEMS + krow * BN +
                                swizzle<BN / 8>(krow, chunk) * 8));
          // the smallest products first
#pragma unroll
          for (int ta = TA - 1; ta >= 0; --ta)
#pragma unroll
            for (int tb = TB - 1; tb >= 0; --tb) {
              if (ta + tb > 2) continue;
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                mma_16816(acc[mi][2 * jp], a[ta][mi], b[tb][0], b[tb][1]);
                mma_16816(acc[mi][2 * jp + 1], a[ta][mi], b[tb][2], b[tb][3]);
              }
            }
        }
      }
    }
    cp_async_wait<0>();

    const int t2 = (lane & 3) * 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int q = q0 + wm * 32 + mi * 16 + (lane >> 2) + h8 * 8;
        if (q >= q1) continue;
        float* rp = part + (size_t)(q - base) * cout;
#pragma unroll
        for (int j = 0; j < NF; ++j)
          store_pair(rp, n0 + wn * WCOLS + j * 8 + t2, cout,
                     acc[mi][j][h8 * 2], acc[mi][j][h8 * 2 + 1]);
      }
    __syncthreads();  // the ring and sIdx are free for the next item
  }
}

// -- 6. reduce ---------------------------------------------------------------

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Each output row j and V columns (8, 4 or 1 as Cout allows): v = acc_in
// (0 for the first group) plus the partials of offsets k0..k1-1 in order;
// to `out` (the last group) or to acc_out.
template <typename OutT, int V>
__global__ void reduce_kernel(const float* __restrict__ part,
                              const int* __restrict__ pos,
                              const int* __restrict__ off,
                              const float* __restrict__ acc_in,
                              float* __restrict__ acc_out,
                              OutT* __restrict__ out, int n_out, int cout,
                              int rb, int k0, int k1) {
  const int base = off[k0 * rb];
  const int cv = cout / V;
  const long long n = (long long)n_out * cv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e / cv), c = (int)(e - (long long)j * cv) * V;
    const size_t at = (size_t)j * cout + c;
    float v[V];
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = acc_in ? acc_in[at + u] : 0.0f;
    // RB offsets at a time: their pair indices, then their partials, are
    // loaded together, and added in offset order
    for (int kb = k0; kb < k1; kb += RB) {
      int p[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
        p[r] = kb + r < k1 ? __ldg(pos + (size_t)(kb + r) * n_out + j) : -1;
      float x[RB][V];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float* src =
            part + (size_t)(p[r] >= 0 ? p[r] - base : 0) * cout + c;
        if constexpr (V >= 4) {
#pragma unroll
          for (int h = 0; h < V / 4; ++h) {
            const float4 y =
                p[r] >= 0 ? reinterpret_cast<const float4*>(src)[h]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
            x[r][4 * h] = y.x;
            x[r][4 * h + 1] = y.y;
            x[r][4 * h + 2] = y.z;
            x[r][4 * h + 3] = y.w;
          }
        } else {
          x[r][0] = p[r] >= 0 ? src[0] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (p[r] >= 0) {
#pragma unroll
          for (int u = 0; u < V; ++u) v[u] += x[r][u];
        }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (out) store_out(out + at + u, v[u]);
      else acc_out[at + u] = v[u];
    }
  }
}

// -- host ----------------------------------------------------------------------

inline int grid_1d(long long work, int threads) {
  const long long b = (work + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b > 8192 ? 8192 : b);
}

inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// The instantiated tiles: BN in {32, 64, 128}; BK in {16, 32, 64} with one
// feature term, {16, 32} with three weight terms, 16 with three of each
// (`ops/fused_conv.py::tile_shape`).
template <int BK, int TA, int TB>
constexpr bool tile_allowed() {
  return TA > 1 ? BK == 16 : TB > 1 ? BK <= 32 : true;
}

template <int BN, int BK, int TA, int TB>
int launch_gemm(const Args& a, int k0, int k1, cudaStream_t stream) {
  if constexpr (!tile_allowed<BK, TA, TB>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    using C = Cfg<BN, BK, TA, TB>;
    auto kernel = gemm_kernel<BN, BK, TA, TB>;
    const int cinf = round_up(a.cin, 8), cinw = round_up(a.cin, BK);
    const int nch = cinw / BK, smem = C::smem(nch);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    // resident blocks on the card, per instantiation and ring slots used
    static int slots[C::STAGES + 1] = {};
    const int used = nch < C::STAGES ? nch : C::STAGES;
    if (slots[used] == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
          (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
          (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, NTHREADS, smem)) != cudaSuccess)
        return (int)e;
      slots[used] = sms * (per_sm > 0 ? per_sm : 1);
    }
    const int ntn = (a.cout + BN - 1) / BN;
    const long long most =
        (long long)((a.n_out + BM - 1) / BM) * (k1 - k0) * ntn;
    const int grid =
        (int)(most < slots[used] ? (most < 1 ? 1 : most) : slots[used]);
    const int rb = (a.n_out + ROWS - 1) / ROWS;
    kernel<<<grid, NTHREADS, smem, stream>>>(
        a.fb, a.wb, a.pair_in, a.off, a.tile_off, a.part, a.n_in, cinf, cinw,
        a.cout, round_up(a.cout, BN), a.k, rb, k0, k1);
    return (int)cudaGetLastError();
  }
}

template <int TA, int TB>
int launch_gemm_tile(const Args& a, int k0, int k1, cudaStream_t s) {
  switch (a.bn * 1000 + a.bk) {
    case 32016: return launch_gemm<32, 16, TA, TB>(a, k0, k1, s);
    case 32032: return launch_gemm<32, 32, TA, TB>(a, k0, k1, s);
    case 32064: return launch_gemm<32, 64, TA, TB>(a, k0, k1, s);
    case 64016: return launch_gemm<64, 16, TA, TB>(a, k0, k1, s);
    case 64032: return launch_gemm<64, 32, TA, TB>(a, k0, k1, s);
    case 64064: return launch_gemm<64, 64, TA, TB>(a, k0, k1, s);
    case 128016: return launch_gemm<128, 16, TA, TB>(a, k0, k1, s);
    case 128032: return launch_gemm<128, 32, TA, TB>(a, k0, k1, s);
    case 128064: return launch_gemm<128, 64, TA, TB>(a, k0, k1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename OutT>
int launch_reduce(const Args& a, int k0, int k1, cudaStream_t s) {
  const bool first = k0 == 0, last = k1 == a.k;
  const int rb = (a.n_out + ROWS - 1) / ROWS;
  const float* acc_in = first ? nullptr : a.acc;
  float* acc_out = last ? nullptr : a.acc;
  OutT* out = last ? (OutT*)a.out : nullptr;
  if (a.cout % 8 == 0) {
    reduce_kernel<OutT, 8><<<grid_1d((long long)a.n_out * a.cout / 8, 256),
                             256, 0, s>>>(a.part, a.pos, a.off, acc_in,
                                          acc_out, out, a.n_out, a.cout, rb,
                                          k0, k1);
  } else if (a.cout % 4 == 0) {
    reduce_kernel<OutT, 4><<<grid_1d((long long)a.n_out * a.cout / 4, 256),
                             256, 0, s>>>(a.part, a.pos, a.off, acc_in,
                                          acc_out, out, a.n_out, a.cout, rb,
                                          k0, k1);
  } else {
    reduce_kernel<OutT, 1><<<grid_1d((long long)a.n_out * a.cout, 256), 256,
                             0, s>>>(a.part, a.pos, a.off, acc_in, acc_out,
                                     out, a.n_out, a.cout, rb, k0, k1);
  }
  return (int)cudaGetLastError();
}

// Every pass up to `a.stage` on `stream` (see the header); returns the first
// error, or cudaGetLastError() after the last launch.
template <int TA, int TB>
int forward(const Args& a, cudaStream_t s) {
  const bool tiles_ok = (a.bn == 32 || a.bn == 64 || a.bn == 128) &&
                        (a.bk == 16 || a.bk == 32 || a.bk == 64);
  if (a.k < 1 || a.k > MAX_K || a.n_in < 1 || a.n_out < 1 ||
      a.cin < 1 || a.cout < 1 || !tiles_ok || a.group < 1 ||
      a.stage < kFull || a.stage > kPairs ||
      (a.group < a.k && a.acc == nullptr))
    return (int)cudaErrorInvalidValue;
  const int cinf = round_up(a.cin, 8), cinw = round_up(a.cin, a.bk);
  const int coutp = round_up(a.cout, a.bn);
  cast_kernel<TA, TB><<<grid_1d((long long)a.n_in * (cinf / 8) +
                                    (long long)a.k * cinw * (coutp / 8),
                                256),
                        256, 0, s>>>(a.feat, a.feat_bf16, a.w, a.w_bf16, a.fb,
                                     a.wb, a.n_in, a.cin, cinf, a.k, a.cout,
                                     cinw, coutp);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || a.stage == kCast) return rc;

  const int rb = (a.n_out + ROWS - 1) / ROWS;
  const dim3 rgrid(rb, (a.k + KB - 1) / KB);
  count_kernel<<<rgrid, ROWS, 0, s>>>(a.nbr, a.cnt, a.n_in, a.n_out, a.k);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(a.cnt, a.off, a.tile_off, rb, a.k);
  compact_kernel<<<rgrid, ROWS, 0, s>>>(a.nbr, a.off, a.pair_in, a.pos,
                                        a.n_in, a.n_out, a.k);
  rc = (int)cudaGetLastError();
  if (rc != 0 || a.stage == kPairs) return rc;

  for (int k0 = 0; k0 < a.k; k0 += a.group) {
    const int k1 = a.k - k0 < a.group ? a.k : k0 + a.group;
    rc = launch_gemm_tile<TA, TB>(a, k0, k1, s);
    if (rc != 0) return rc;
    rc = a.feat_bf16 ? launch_reduce<__nv_bfloat16>(a, k0, k1, s)
                     : launch_reduce<float>(a, k0, k1, s);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace map_conv

// The C entry of a source that includes this header: feat [n_in, cin] fp32
// (feat_bf16 == 0) or bf16, w [k, cin, cout] fp32 (w_bf16 == 0) or bf16,
// nbr int32 [k, n_out] (outside [0, n_in) = missing), out [n_out, cout] in
// the features' dtype.  Buffers (device, written here; `ops/onehot_conv.py::
// _map_workspace`): fb bf16 [TA][n_in, cin rounded up to 8], wb bf16 [TB][k,
// cin rounded up to bk, cout rounded up to bn], cnt int32 [k * rb], off
// int32 [k * rb + 1] (rb = ceil(n_out / 256)), tile_off int32 [k + 1],
// pair_in and pos int32 [k * n_out], part fp32 [group * n_out * cout], acc
// fp32 [n_out * cout] (unused with group >= k); (bn, bk) the GEMM tile
// (`fused_conv.tile_shape`), group the offsets per GEMM launch (`map_groups`),
// stage a Stage.
#define MAP_CONV_ENTRY_PARAMS                                                  \
  const void *feat, int feat_bf16, const void *w, int w_bf16,                  \
      const void *nbr, void *out, void *fb, void *wb, void *cnt, void *off,    \
      void *tile_off, void *pair_in, void *pos, void *part, void *acc,         \
      int n_in, int n_out, int cin, int cout, int k, int bn, int bk,           \
      int group, int stage, void *stream

#define MAP_CONV_ARGS                                                          \
  map_conv::Args {                                                             \
    feat, feat_bf16, w, w_bf16, (const int*)nbr, out, (__nv_bfloat16*)fb,      \
        (__nv_bfloat16*)wb, (int*)cnt, (int*)off, (int*)tile_off,              \
        (int*)pair_in, (int*)pos, (float*)part, (float*)acc, n_in, n_out, cin, \
        cout, k, bn, bk, group, stage                                          \
  }
