// Fused sparse-conv forward for Hopper (sm_90a): neighbour search + row
// gather + bf16 tensor-core GEMM with fp32 accumulation, in one kernel.
//
// Replaces the TPU kernel `ops/onehot_conv.py::_fused_impl` of the JAX
// package (Pallas `pallas_call`), reached there through
// `fused_sparse_conv`, in both of its directions:
//   - the forward conv (B1): for every output row j and kernel offset k,
//     out_j = sum_k f[match_k(j)] . W_k   (a miss adds zero), with the match
//     rule of `sparse_conv_common.cuh`;
//   - the dF backward (B2, `_FusedStatic.flipped`): the same search run in
//     the transpose direction -- the grids swap roles, the offsets negate,
//     the searched lattice is the forward's output lattice -- over the
//     cotangent g with W_k transposed, which the operand cast below
//     applies.
// One kernel covers plain k3s1, strided k3s2, pinned transpose k2s2 and
// generative k2s2 convs in both directions, on 3-D and 2-D grids: only the
// offsets, strides and the geometry's D (`sparse_conv_common.cuh`) differ.
//
// Compute dtype.  The TPU kernel takes `compute_dtype` bf16 or float32
// ("full precision at reduced MXU rate").  The products are a template
// parameter (TA, TB), the bf16 terms of the features and of the weight
// (`split`, `hopper_mma.cuh`), as in B7 (`map_conv.cuh`):
//   - bf16 compute: (1, 1), one bf16 product, as the TPU kernel;
//   - float32 compute: (3, 3), the 6 products a_i . b_j with i + j <= 2,
//     fp32-accurate (the dropped ones are below 2^-24 of the result); on a
//     weight stored in bf16, which one term holds exactly, (3, 1), 3
//     products.
// The split-term instantiations keep the ring within ~24 KB a stage with
// BK = 16 (`ops/fused_conv.py::tile_shape`) and serve only the full conv.
// They also sum in two levels: each ring step's products accumulate on the
// tensor cores from zero, and are then added to a second fp32 sum on the
// CUDA cores.  The tensor cores' fp32 accumulation aligns its addends by
// truncation, an error that grows with the number of k16 products chained
// into one accumulator: chained over K x Cin = 27 x 512 (864 steps x 6
// products) it reached 5e-5 of max|out| on the H100, above the 2e-5 that
// a float32 result must meet; one step's chain keeps it at the fp32 sum's.
//
// What bounds it on the H100: at the widths of the main path (Cin, Cout in
// 1..512, 2,048 to 131,072 rows) one conv's arithmetic intensity is far
// below the ~295 FLOP/byte the card needs to be compute bound, so its
// bound is the bytes it must move (features, weights, keys, coordinates
// once, the output once) or, at 512 -> 512, the matched pairs' operations.
// The first design ran ~90x its bound: each block of 64 rows x 64
// Cout repeated all K binary searches for every Cout tile, gathered fp32
// rows 4 bytes a thread and converted them in place, re-read and
// converted the fp32 W_k chunk for every row tile, and loaded
// synchronously between two wmma steps.  This design:
//   - each operand is cast once per call, by a pass in this file that
//     runs before the conv (`cast_operands_kernel`; its plain versions are
//     `ops/fused_conv.py::pad_features` and `pack_weight`): features to
//     bf16 [n_in, CinF] (CinF a multiple of 8, zero-filled), the weight to
//     bf16 [K, CinW, CoutP] (CinW a multiple of the chunk BK, CoutP of the
//     tile BN, zero-filled; transposed in the same pass for dF);
//   - a row tile of 128 output rows is searched once: the K searches fill
//     sIdx[K][128] in shared memory, offsets with no match in the tile are
//     dropped from a compact list; the tile's C = min(Cout tiles, 8)
//     blocks form a thread-block cluster, block y searching a C-th of the
//     offsets and reading the others' sIdx through distributed shared
//     memory, and walking Cout tiles y, y + C, ... (so a wide conv over few
//     rows still fills the card); a tile whose rows are all invalid (the
//     padding of the decoder's levels) writes zeros and exits at once;
//   - a ring of 3-6 stages over (live offset, BK-channel Cin chunk): the
//     matched rows are gathered with 16-byte `cp.async` copies into an
//     XOR-swizzled tile (zero-filled on a miss; Hopper's TMA has no row
//     gather), the W_k box with 16-byte `cp.async` copies, and the copies
//     of the next stages are in flight while one stage multiplies;
//   - the product on the tensor cores through `mma.sync.m16n8k16` and
//     `ldmatrix` (`hopper_mma.cuh`), both swizzled tiles free of bank
//     conflicts; 8 warps as 4 x 2, each 32 rows x BN/2 columns.  A
//     `wgmma` version of this product (two warpgroups of 64 rows, A from
//     registers, the W_k box as MN-major core matrices read through a
//     descriptor) gave the same output bit for bit but ran 10-20% slower
//     per launch on the H100 in this ring, where each stage ends in a
//     barrier before its slot is refilled (PERF.md), so the warp-level
//     product stays;
//   - the epilogue stores fp32 pairs from the accumulators, masked at the
//     ragged rows and columns.
// What is left: the gathered rows are re-read for each Cout tile past the
// first; a tile multiplies its missed rows as zeros; the gather is
// latency bound (a warp-specialised producer and a deeper ring would hide
// it, and let `wgmma` run ahead of the barrier); the wrapper's host path
// (checks, the launch) is longer than the kernel for the narrow convs.
//
// Tiles: BM = 128 rows; BN in {32, 64, 128} after Cout and BK in {16, 32,
// 64} after Cin, BK 16 with split terms (`ops/fused_conv.py::tile_shape`).
//
// Stages (`stage`, default kFull): the same kernel cut at a point of its
// pipeline, so that each stage's cost on the card can be seen.  They
// replace the TPU kernels `scripts/bench_kernel_parts.py::variant_conv`
// (B8) and `scripts/bench_parts_finest.py::variant` (B9), which cut
// `_fused_impl` the same way (`empty`, `dma` + `compare`, `matmul`,
// `full`).  Each stage writes an output that depends on all of its work:
//   - kEmpty:  zeros (launch and grid overhead);
//   - kSearch: column 0 = the number of offsets matched for the row, other
//     columns 0 (every query key and all K searches run);
//   - kGather: out[j, c] = sum_k bf16(f[match_k(j), c]) in fp32 for
//     c < min(Cin, Cout), else 0 (the search and every gather of every
//     Cout tile run; no weight load, no product);
//   - kFull:   the conv itself (B1/B2): `full` launches the very
//     instantiation that B1 launches, so its output is B1's bit for bit.
//
// Work counted (`work`, int64 [3], null unless the caller records it;
// `utils/profiling.py`): the first block of each row tile's cluster adds
// the tile's matched (output row, offset) pairs into work[0] and its valid
// output rows into work[2], one atomic add a warp; block (0, 0) adds the
// valid input keys (`count_valid_keys`) into work[1].  The counting reads
// sIdx after the cluster's exchange and adds no barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "sparse_conv_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;
using sparse_conv::Geom;
using sparse_conv::MAX_K;

constexpr int BM = 128;  // output rows per block
constexpr int NTHREADS = 256;
constexpr int MAX_CLUSTER = 8;  // blocks of a row tile (portable cluster size)

enum Stage { kFull = 0, kEmpty = 1, kSearch = 2, kGather = 3 };

template <int BN, int BK, int TA, int TB>
struct Cfg {
  static constexpr int A_ELEMS = BM * BK;  // one term's gathered rows, swizzled
  static constexpr int B_ELEMS = BK * BN;  // one term's W_k box, swizzled
  static constexpr int STAGE_ELEMS = TA * A_ELEMS + TB * B_ELEMS;
  static constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
  static constexpr int STAGES =
      STAGE_BYTES > 24576 ? 3 : STAGE_BYTES > 16384 ? 4 : 6;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
};

// Dynamic shared memory: the ring, sIdx [K][BM], the live-offset list
// (MAX_K + 1 ints, its count last), the block's 4-word mask of live
// offsets and the cluster's.
template <int BN, int BK, int TA, int TB>
size_t smem_bytes(int k) {
  return (size_t)Cfg<BN, BK, TA, TB>::RING_BYTES +
         ((size_t)k * BM + MAX_K + 1 + 8) * 4;
}

// feat [TA][n_in, cinf] and wp [TB][k, cinw, coutp], the operands' bf16
// terms (one each with bf16 compute).  A split-term instantiation's ring
// and sIdx leave room for one block an SM.
template <int BN, int BK, int TA, int TB, int kStage>
__global__ void __launch_bounds__(NTHREADS, TA > 1 ? 1 : 2)
    fused_sparse_conv_kernel(
    const __nv_bfloat16* __restrict__ feat,
    const __nv_bfloat16* __restrict__ wp, const int* __restrict__ in_keys,
    const int* __restrict__ out_coords,
    const unsigned char* __restrict__ out_valid, float* __restrict__ out,
    int n_in, int n_out, int cinf, int cin, int cinw, int cout, int coutp,
    const Geom g, unsigned long long* __restrict__ work) {
  using C = Cfg<BN, BK, TA, TB>;
  static_assert(kStage == kFull || (TA == 1 && TB == 1),
                "the cut stages are bf16 only");
  constexpr int STAGES = C::STAGES;
  constexpr int WCOLS = BN / 2;   // a warp's columns
  constexpr int NF = WCOLS / 8;   // its n8 tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sRing = reinterpret_cast<__nv_bfloat16*>(smem);
  int* sIdx = reinterpret_cast<int*>(smem + C::RING_BYTES);
  int* sLive = sIdx + g.k * BM;
  unsigned* sMask = reinterpret_cast<unsigned*>(sLive + MAX_K + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  // the cluster of a row tile spans the grid's y: block y of C takes Cout
  // tiles y, y + C, ... and a C-th of the search
  const int crank = blockIdx.y, csize = gridDim.y;
  const int ntn = (cout + BN - 1) / BN;
  if (work != nullptr && blockIdx.x == 0 && crank == 0 && tid == 0)
    atomicAdd(work + 1, (unsigned long long)sparse_conv::count_valid_keys(
                            in_keys, n_in));
  // out[row0 + r][c] = f(r, c) over the block's rows and Cout tiles
  auto fill = [&](auto f) {
    const int rows = min(BM, n_out - row0);
    for (int t = crank; t < ntn; t += csize) {
      const int c0 = t * BN, w = min(BN, cout - c0);
      for (int e = tid; e < rows * w; e += NTHREADS) {
        const int rr = e / w, c = c0 + e - rr * w;
        out[(size_t)(row0 + rr) * cout + c] = f(rr, c);
      }
    }
  };
  auto zero = [](int, int) { return 0.0f; };
  if constexpr (kStage == kEmpty) {
    fill(zero);
    return;
  }

  // thread (r, half) of block y searches row r's offsets k = 2y + half
  // (mod 2C); the cluster then shares sIdx through distributed shared
  // memory, so each (row, offset) is searched once
  const int r = tid & (BM - 1), half = tid >> 7;
  int coord[1 + sparse_conv::MAX_D] = {-1, 0, 0, 0};
  sparse_conv::with_ndim(g, [&](auto nd) {
    sparse_conv::load_coord<decltype(nd)::value>(coord, row0 + r, n_out,
                                                 out_coords, out_valid);
  });
  if (tid < 8) sMask[tid] = 0u;
  // the same for every block of the cluster: all exit, or none
  if (!__syncthreads_or(coord[0] >= 0)) {  // all rows invalid or past the end
    fill(zero);
    return;
  }
  sparse_conv::with_ndim(g, [&](auto nd) {
    for (int k = 2 * crank + half; k < g.k; k += 2 * csize) {
      const int f = sparse_conv::find_neighbor<decltype(nd)::value>(
          coord, k, g, in_keys, n_in);
      sIdx[k * BM + r] = f;
      // a warp's lanes share k
      if (__any_sync(0xffffffffu, f >= 0) && lane == 0)
        atomicOr(&sMask[k >> 5], 1u << (k & 31));
    }
  });
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's searches are done and visible
  if (csize > 1) {
    for (int e = tid; e < g.k * BM; e += NTHREADS) {
      const int owner = ((e / BM) % (2 * csize)) >> 1;
      if (owner != crank) sIdx[e] = *cluster.map_shared_rank(sIdx + e, owner);
    }
    if (tid < 4) {
      unsigned m = 0u;
      for (int b = 0; b < csize; ++b) m |= *cluster.map_shared_rank(sMask + tid, b);
      sMask[4 + tid] = m;
    }
    cluster.sync();  // no block leaves while another reads its shared memory
  }
  __syncthreads();
  const unsigned* sLiveMask = csize > 1 ? sMask + 4 : sMask;
  if (work != nullptr && crank == 0 && half == 0) {  // warps 0-3: row r
    int n = 0;
    for (int k = 0; k < g.k; ++k) n += sIdx[k * BM + r] >= 0;
    n = __reduce_add_sync(0xffffffffu, n);
    const int v = __reduce_add_sync(0xffffffffu, coord[0] >= 0 ? 1 : 0);
    if (lane == 0) {
      atomicAdd(work, (unsigned long long)n);
      atomicAdd(work + 2, (unsigned long long)v);
    }
  }

  if constexpr (kStage == kSearch) {
    int* sCnt = reinterpret_cast<int*>(smem);  // the ring is unused
    if (half == 0) {
      int n = 0;
      for (int k = 0; k < g.k; ++k) n += sIdx[k * BM + r] >= 0;
      sCnt[r] = n;
    }
    __syncthreads();
    fill([&](int rr, int c) { return c == 0 ? (float)sCnt[rr] : 0.0f; });
    return;
  }

  if (tid == 0) {  // the live offsets, in order
    int n = 0;
    for (int k = 0; k < g.k; ++k)
      if ((sLiveMask[k >> 5] >> (k & 31)) & 1u) sLive[n++] = k;
    sLive[MAX_K] = n;
  }
  __syncthreads();
  const int nch = cinw / BK;
  const int steps = sLive[MAX_K] * nch;  // (live offset, Cin chunk)
  const int wm = warp & 3, wn = warp >> 2;
  const int mlim = min(cin, cout);  // kGather's columns
  const size_t fterm = (size_t)n_in * cinf;           // a feature term
  const size_t wterm = (size_t)g.k * cinw * coutp;    // a weight term

  for (int tn = crank; tn < ntn; tn += csize) {
    const int n0 = tn * BN;
    // step s: every term's gathered rows of (offset, chunk) and, for the
    // product, every term's W_k box, as one cp.async group (empty past the
    // last step)
    auto load_step = [&](int s) {
      if (s < steps) {
        const int li = s / nch, c0 = (s - li * nch) * BK, k = sLive[li];
        __nv_bfloat16* sA = sRing + (s % STAGES) * C::STAGE_ELEMS;
        const int* idx = sIdx + k * BM;
        for (int e = tid; e < BM * (BK / 8); e += NTHREADS) {
          const int row = e / (BK / 8), seg = e % (BK / 8);
          const int src = idx[row], ch = c0 + seg * 8;
          const bool ok = src >= 0 && ch < cinf;
          const uint32_t dst =
              smem_u32(sA + row * BK + swizzle<BK / 8>(row, seg) * 8);
          const size_t so = ok ? (size_t)src * cinf + ch : 0;
#pragma unroll
          for (int a = 0; a < TA; ++a)
            cp_async16(dst + a * C::A_ELEMS * 2, feat + a * fterm + so,
                       ok ? 16 : 0);
        }
        if constexpr (kStage == kFull) {
          __nv_bfloat16* sB = sA + TA * C::A_ELEMS;
          const __nv_bfloat16* wk =
              wp + ((size_t)k * cinw + c0) * coutp + n0;
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
      }
      cp_async_commit();
    };

    float acc[2][NF][4];  // kFull: 32 rows x WCOLS of the warp
    float tot[2][NF][4];  // split terms: the sum of the steps' acc
    float gsum[WCOLS];    // kGather: row r, columns half * WCOLS + j
    if constexpr (kStage == kFull) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < NF; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][j][i] = tot[mi][j][i] = 0.0f;
    } else {
#pragma unroll
      for (int j = 0; j < WCOLS; ++j) gsum[j] = 0.0f;
    }

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) load_step(s);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<STAGES - 2>();  // step s has landed ...
      __syncthreads();  // ... for every thread; stage (s - 1) % STAGES is free
      load_step(s + STAGES - 1);
      const __nv_bfloat16* sA = sRing + (s % STAGES) * C::STAGE_ELEMS;
      if constexpr (kStage == kFull) {
        const __nv_bfloat16* sB = sA + TA * C::A_ELEMS;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[TA][2][4];
#pragma unroll
          for (int ta = 0; ta < TA; ++ta)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const int row = wm * 32 + mi * 16 + (lane & 15);
              ldmatrix_x4(a[ta][mi],
                          smem_u32(sA + ta * C::A_ELEMS + row * BK +
                                   swizzle<BK / 8>(row, kk * 2 + (lane >> 4)) * 8));
            }
          const int krow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int jp = 0; jp < NF / 2; ++jp) {
            const int chunk = (wn * WCOLS + jp * 16) / 8 + (lane >> 4);
            uint32_t b[TB][4];
#pragma unroll
            for (int tb = 0; tb < TB; ++tb)
              ldmatrix_x4_trans(
                  b[tb], smem_u32(sB + tb * C::B_ELEMS + krow * BN +
                                  swizzle<BN / 8>(krow, chunk) * 8));
            // the term products a_i . b_j with i + j <= 2, the smallest first
#pragma unroll
            for (int ta = TA - 1; ta >= 0; --ta)
#pragma unroll
              for (int tb = TB - 1; tb >= 0; --tb) {
                if (ta + tb > 2) continue;
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                  mma_16816(acc[mi][2 * jp], a[ta][mi], b[tb][0], b[tb][1]);
                  mma_16816(acc[mi][2 * jp + 1], a[ta][mi], b[tb][2],
                            b[tb][3]);
                }
              }
          }
        }
        if constexpr (TA > 1) {  // the step's sum into the fp32 total
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < NF; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                tot[mi][j][i] += acc[mi][j][i];
                acc[mi][j][i] = 0.0f;
              }
        }
      } else {  // kGather: add the chunk's columns that are this row's
        const int li = s / nch, c0 = (s - li * nch) * BK;
        const int lo = n0 + half * WCOLS;
        if (c0 < min(lo + WCOLS, mlim) && c0 + BK > lo) {
#pragma unroll
          for (int j = 0; j < WCOLS; ++j) {
            const int col = lo + j, cc = col - c0;
            if (cc >= 0 && cc < BK && col < mlim)
              gsum[j] += __bfloat162float(
                  sA[r * BK + swizzle<BK / 8>(r, cc >> 3) * 8 + (cc & 7)]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next Cout tile

    if constexpr (kStage == kFull) {
      const int t2 = (lane & 3) * 2;
      if constexpr (TA > 1) {  // the two-level sum is the result
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mi][j][i] = tot[mi][j][i];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8) {
          const int row = row0 + wm * 32 + mi * 16 + (lane >> 2) + h8 * 8;
          if (row >= n_out) continue;
          float* rp = out + (size_t)row * cout;
#pragma unroll
          for (int j = 0; j < NF; ++j)
            store_pair(rp, n0 + wn * WCOLS + j * 8 + t2, cout,
                       acc[mi][j][h8 * 2], acc[mi][j][h8 * 2 + 1]);
        }
    } else if (row0 + r < n_out) {
      float* rp = out + (size_t)(row0 + r) * cout;
#pragma unroll
      for (int j = 0; j < WCOLS; ++j) {
        const int col = n0 + half * WCOLS + j;
        if (col < cout) rp[col] = gsum[j];
      }
    }
  }
}

struct Args {
  const void *feat, *wp, *in_keys, *out_coords, *out_valid;
  void* out;
  int n_in, n_out, cinf, cin, cinw, cout, coutp;
  void* work;
};

template <int BN, int BK, int TA, int TB, int kStage>
int launch(const Args& a, const Geom& g, cudaStream_t stream) {
  auto kernel = fused_sparse_conv_kernel<BN, BK, TA, TB, kStage>;
  const size_t smem = kStage == kEmpty ? 0 : smem_bytes<BN, BK, TA, TB>(g.k);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // one cluster of C blocks per row tile, C = the Cout tiles (at most 8)
  const int csize = min((a.cout + BN - 1) / BN, MAX_CLUSTER);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n_out + BM - 1) / BM, csize, 1);
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = csize;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, (const __nv_bfloat16*)a.feat, (const __nv_bfloat16*)a.wp,
      (const int*)a.in_keys, (const int*)a.out_coords,
      (const unsigned char*)a.out_valid, (float*)a.out, a.n_in, a.n_out,
      a.cinf, a.cin, a.cinw, a.cout, a.coutp, g,
      (unsigned long long*)a.work);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int kStage>
int launch_tile(int bn, int bk, const Args& a, const Geom& g,
                cudaStream_t s) {
  switch (bn * 1000 + bk) {
    case 32016: return launch<32, 16, 1, 1, kStage>(a, g, s);
    case 32032: return launch<32, 32, 1, 1, kStage>(a, g, s);
    case 32064: return launch<32, 64, 1, 1, kStage>(a, g, s);
    case 64016: return launch<64, 16, 1, 1, kStage>(a, g, s);
    case 64032: return launch<64, 32, 1, 1, kStage>(a, g, s);
    case 64064: return launch<64, 64, 1, 1, kStage>(a, g, s);
    case 128016: return launch<128, 16, 1, 1, kStage>(a, g, s);
    case 128032: return launch<128, 32, 1, 1, kStage>(a, g, s);
    case 128064: return launch<128, 64, 1, 1, kStage>(a, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split-term full conv: BK 16, BN after Cout.
template <int TA, int TB>
int launch_split(int bn, const Args& a, const Geom& g, cudaStream_t s) {
  switch (bn) {
    case 32: return launch<32, 16, TA, TB, kFull>(a, g, s);
    case 64: return launch<64, 16, TA, TB, kFull>(a, g, s);
    case 128: return launch<128, 16, TA, TB, kFull>(a, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The operand casts, one pass before the conv (`ops/fused_conv.py::
// pad_features` and `pack_weight` are their plain versions): features fp32
// [n_in, cin] -> TA bf16 terms [TA][n_in, cinf], zero past cin; weight W
// (fp32, or bf16 where the parameters are stored in bf16) [k, cin, cout]
// ([k, cout, cin], the forward's, read transposed for dF) -> TB bf16 terms
// [TB][k, cinw, coutp], zero past cin and cout.  Each term rounds to
// nearest what the earlier ones left (`split`; one term is
// __float2bfloat16, and a bf16 weight is copied as it is).
__device__ __forceinline__ float load_weight(const float* w, long long i) {
  return w[i];
}
__device__ __forceinline__ float load_weight(const __nv_bfloat16* w,
                                             long long i) {
  return __bfloat162float(w[i]);
}

template <typename W, int TA, int TB>
__global__ void cast_operands_kernel(const float* __restrict__ f,
                                     __nv_bfloat16* __restrict__ fb,
                                     const W* __restrict__ w,
                                     __nv_bfloat16* __restrict__ wp,
                                     int n_in, int cin, int cinf, int cout,
                                     int k, int cinw, int coutp,
                                     int transpose) {
  const long long nf = (long long)n_in * cinf;
  const long long nw = (long long)k * cinw * coutp;
  const long long total = nf + nw;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (e < nf) {
      const long long r = e / cinf;
      const int c = (int)(e - r * cinf);
      __nv_bfloat16 t[TA];
      split(c < cin ? f[r * cin + c] : 0.0f, t);
#pragma unroll
      for (int u = 0; u < TA; ++u) fb[u * nf + e] = t[u];
    } else {
      const long long q = e - nf;
      const long long o = q / ((long long)cinw * coutp);
      const int rem = (int)(q - o * cinw * coutp);
      const int i = rem / coutp, j = rem - i * coutp;
      float v = 0.0f;
      if (i < cin && j < cout)
        v = load_weight(w, transpose ? (o * cout + j) * cin + i
                                     : (o * cin + i) * cout + j);
      __nv_bfloat16 t[TB];
      split(v, t);
#pragma unroll
      for (int u = 0; u < TB; ++u) wp[u * nw + q] = t[u];
    }
  }
}

template <int TA, int TB>
int cast_terms(const void* feat, const void* w, void* fb, void* wp,
               int n_in, int cin, int cout, int k, int bn, int bk,
               int transpose, int w_bf16, cudaStream_t stream) {
  const int cinf = (cin + 7) / 8 * 8, cinw = (cin + bk - 1) / bk * bk;
  const int coutp = (cout + bn - 1) / bn * bn;
  const long long total =
      (long long)n_in * cinf + (long long)k * cinw * coutp;
  const int blocks = (int)(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  if (w_bf16)
    cast_operands_kernel<__nv_bfloat16, TA, TB><<<blocks, 256, 0, stream>>>(
        (const float*)feat, (__nv_bfloat16*)fb, (const __nv_bfloat16*)w,
        (__nv_bfloat16*)wp, n_in, cin, cinf, cout, k, cinw, coutp,
        transpose);
  else
    cast_operands_kernel<float, TA, TB><<<blocks, 256, 0, stream>>>(
        (const float*)feat, (__nv_bfloat16*)fb, (const float*)w,
        (__nv_bfloat16*)wp, n_in, cin, cinf, cout, k, cinw, coutp,
        transpose);
  return (int)cudaGetLastError();
}

int cast_operands(const void* feat, const void* w, void* fb, void* wp,
                  int n_in, int cin, int cout, int k, int bn, int bk, int ta,
                  int tb, int transpose, int w_bf16, cudaStream_t stream) {
  switch (ta * 10 + tb) {
    case 11: return cast_terms<1, 1>(feat, w, fb, wp, n_in, cin, cout, k, bn,
                                     bk, transpose, w_bf16, stream);
    case 33: return cast_terms<3, 3>(feat, w, fb, wp, n_in, cin, cout, k, bn,
                                     bk, transpose, w_bf16, stream);
    case 31: return cast_terms<3, 1>(feat, w, fb, wp, n_in, cin, cout, k, bn,
                                     bk, transpose, w_bf16, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiles and term counts instantiated: (1, 1) on every tile; (3, 3)
// and (3, 1) with BK 16.
bool valid_tile(int bn, int bk, int ta, int tb) {
  const bool terms = (ta == 1 && tb == 1) || (ta == 3 && (tb == 3 || tb == 1));
  return terms && (bn == 32 || bn == 64 || bn == 128) &&
         (ta > 1 ? bk == 16 : (bk == 16 || bk == 32 || bk == 64));
}

}  // namespace

// The operand casts alone (the pass `fused_sparse_conv_forward` runs
// first): feat fp32 [n_in, cin] -> fb bf16 [ta][n_in, cin rounded up to
// 8]; w fp32, or bf16 with w_bf16, [k, cin, cout] ([k, cout, cin] with
// transpose) -> wp bf16 [tb][k, cin rounded up to bk, cout rounded up to
// bn]; (ta, tb) the terms, (1, 1), (3, 3) or (3, 1).
extern "C" int fused_sparse_conv_cast(const void* feat, const void* w,
                                      void* fb, void* wp, int n_in, int cin,
                                      int cout, int k, int bn, int bk,
                                      int ta, int tb, int transpose,
                                      int w_bf16, void* stream) {
  if (n_in < 0 || cin < 1 || cout < 1 || k < 1 ||
      !valid_tile(bn, bk, ta, tb))
    return (int)cudaErrorInvalidValue;
  return cast_operands(feat, w, fb, wp, n_in, cin, cout, k, bn, bk, ta, tb,
                       transpose, w_bf16, (cudaStream_t)stream);
}

// Launch on `stream`: the operand casts into fb and wp (as
// `fused_sparse_conv_cast`, the weight bf16 with w_bf16), then the conv;
// returns cudaGetLastError() right after the launches.  in_keys int32
// [n_in] (sorted, INT32_MAX on padding rows), out_coords int32 [n_out, 1 +
// ndim], out_valid bool [n_out], out fp32 [n_out, cout]; offs [k*ndim],
// s_in [ndim] and cells [ndim] are host arrays, ndim 2 or 3.  (bn, bk) is
// the tile and (ta, tb) the terms (`ops/fused_conv.py::tile_shape`,
// `operand_terms`); `stage` a Stage (see the header), the cut stages with
// (1, 1) only; transpose only with kFull (B2); work int64 [3] zeroed, into
// which the conv adds its matched pairs and valid rows read and written,
// or null.
extern "C" int fused_sparse_conv_forward(
    const void* feat, const void* w, void* fb, void* wp, const void* in_keys,
    const void* out_coords, const void* out_valid, void* out, int n_in,
    int n_out, int cin, int cout, int k, int ndim, const int* offs,
    const int* s_in, const int* cells, int bn, int bk, int ta, int tb,
    int transpose, int w_bf16, int stage, void* work, void* stream) {
  if (k < 1 || k > MAX_K || ndim < 2 || ndim > sparse_conv::MAX_D ||
      n_in < 1 || n_out < 1 || cout < 1 || cin < 1 ||
      !valid_tile(bn, bk, ta, tb) || stage < kFull || stage > kGather ||
      (transpose && stage != kFull) || (ta > 1 && stage != kFull))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = cast_operands(feat, w, fb, wp, n_in, cin, cout, k, bn, bk, ta, tb,
                         transpose, w_bf16, s);
  if (rc != 0) return rc;
  const Args a{fb, wp, in_keys, out_coords, out_valid, out, n_in, n_out,
               (cin + 7) / 8 * 8, cin, (cin + bk - 1) / bk * bk, cout,
               (cout + bn - 1) / bn * bn, work};
  const Geom g = sparse_conv::make_geom(k, ndim, offs, s_in, cells);
  if (ta == 3) {  // the split-term full conv (float32 compute)
    return tb == 3 ? launch_split<3, 3>(bn, a, g, s)
                   : launch_split<3, 1>(bn, a, g, s);
  }
  switch (stage) {  // each stage on the tile and cluster of the conv
    case kEmpty: return launch_tile<kEmpty>(bn, bk, a, g, s);
    case kSearch: return launch_tile<kSearch>(bn, bk, a, g, s);
    case kGather: return launch_tile<kGather>(bn, bk, a, g, s);
    default: return launch_tile<kFull>(bn, bk, a, g, s);
  }
}

extern "C" const char* fused_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
