// Fused sparse-conv weight gradient (dW, B3) for Hopper (sm_90a): bf16
// cast, one neighbour search per (row, offset) compacted into a pair list,
// then a pipelined bf16 tensor-core GEMM over the pairs with fp32
// accumulation and a deterministic split reduction.
//
// Replaces the TPU kernel `ops/onehot_conv.py::_dkernel_fused` of the JAX
// package (Pallas `pallas_call`), the dW half of `_fused_conv`'s backward:
//   dW[k, Cin, Cout] = sum_j bf16(f[match_k(j)])^T . bf16(g_j)
// over the valid output rows j with a match for offset k, with the forward's
// query and match rule (`sparse_conv_common.cuh`), fp32 accumulation and an
// fp32 result.  Its plain form is the JAX package's `_dkernel_gather`; the
// port's plain version is `ops/fused_conv.py::_dkernel_plain`.
//
// What bounds it on the H100: at 512 -> 512 the matched pairs' operations,
// 2 * pairs * Cin * Cout (0.155 ms of tensor-core time at 16,384 rows, K
// 27); at the narrow widths (Cin, Cout <= 128) the bytes -- features,
// cotangent, keys and coordinates once, dW once -- and, below a few MB,
// the latency of the dependent steps (search, gather).  The first design
// ran ~95x its bound: every (Cin tile, Cout tile) block of an offset
// searched its rows again, gathered fp32 rows with scalar loads and cast
// them in the inner loop, multiplied whole 64-row tiles of which few rows
// matched, loaded synchronously between two wmma steps, and summed its row
// splits with fp32 atomics (a result that changed from run to run).  This
// design runs up to six passes from one host call, on one stream:
//   1. cast (`cast_kernel`): f to bf16 [n_in, CinF] and g to bf16 [n_out,
//      CoutF], CinF/CoutF the widths rounded up to 8 (one 16-byte copy per
//      8 channels), zero past the width, once per call (plain version
//      `ops/fused_conv.py::dw_operands`, i.e. `pad_features` of each);
//   2. search (`search_kernel`): one thread per (output row, offset) runs
//      `find_neighbor` once into an int32 map [K, n_out] and the block of
//      256 rows counts its matches per offset;
//   3. scan (`scan_kernel`, one block): the exclusive prefix sum of those
//      counts in (offset, row block) order, so that offset k's pairs start
//      at off[k * row_blocks] and end at off[(k + 1) * row_blocks];
//   4. compaction (`compact_kernel`): each row block writes its matched
//      (input row i, output row j) pairs at its place, in ascending j
//      (plain version `ops/fused_conv.py::pair_list`); the GEMM's depth is
//      then exactly the matched pairs, the count the bound reckons;
//   5. GEMM (`gemm_kernel`): one 256-thread block per (Cin tile, Cout tile,
//      offset, split) streams its share of the offset's pairs in chunks of
//      BD pairs through a ring of 3-4 `cp.async` stages, each holding the
//      gathered bf16 f rows [BD, BI] and g rows [BD, BO] in XOR-swizzled
//      shared memory (the pair indices of the next chunk are loaded into
//      registers while the tensor cores work on the current one);
//      `mma.sync.m16n8k16` with A = f^T and B = g both from
//      `ldmatrix_x4_trans` and fp32 accumulators in registers; where the
//      tile holds fewer than 8 warp tiles the warps also split each chunk's
//      depth, and sum in a fixed order at the end.  A block whose split
//      holds no pair writes zeros and loads nothing.
//   6. reduce (`reduce_kernel`), only where one split per block would leave
//      too few blocks to fill the card (narrow layers, few offsets): the
//      GEMM writes fp32 partials [S, K, Cin, Cout] and this pass sums them
//      in split order.  With S = 1 the GEMM writes dW itself.  No atomics:
//      dW is the same bit for bit from run to run.
// Tiles (`ops/fused_conv.py::dw_tile_shape`, `dw_splits`): BI and BO each
// the smallest of 32/64 that holds Cin/Cout, else 128; BD = 64 pairs, 128
// for the 32x32 tile; S from the block count, the depth and a 16 MiB
// bound on the partials.
// What is left: each gathered f row is read again for each Cout tile and
// each g row for each Cin tile (from L2: at 512 -> 512 both operands fit
// it); a warp-specialised producer and `wgmma` are later work.
//
// Stages (`stage`): kFull runs every pass; kCast stops after the cast and
// kPairs after the compaction, so that the card tests can hold each pass
// against its plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "sparse_conv_common.cuh"

// A named namespace: a profile finds every pass of B3 by
// "fused_sparse_conv_dw::".
namespace fused_sparse_conv_dw {

using namespace hopper;
using sparse_conv::Geom;

constexpr int NTHREADS = 256;  // a GEMM block
constexpr int ROWS = 256;      // output rows of a search or compaction block
constexpr int SCAN_THREADS = 1024;

enum Stage { kFull = 0, kCast = 1, kPairs = 2 };

// -- 1. cast -----------------------------------------------------------------

// f fp32 [n_in, cin] -> fb bf16 [n_in, cinf] and g fp32 [n_out, cout] -> gb
// bf16 [n_out, coutf], zero past the width; one thread per 16-byte chunk.
__global__ void cast_kernel(const float* __restrict__ f,
                            __nv_bfloat16* __restrict__ fb, int n_in,
                            int cin, int cinf, const float* __restrict__ g,
                            __nv_bfloat16* __restrict__ gb, int n_out,
                            int cout, int coutf) {
  const long long nf = (long long)n_in * (cinf / 8);
  const long long total = nf + (long long)n_out * (coutf / 8);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const bool is_f = e < nf;
    const long long q = is_f ? e : e - nf;
    const int cpr = (is_f ? cinf : coutf) / 8;
    const long long r = q / cpr;
    const int c = (int)(q - r * cpr) * 8, w = is_f ? cin : cout;
    const float* src = is_f ? f + r * cin : g + r * cout;
    __nv_bfloat16* dst = is_f ? fb + r * cinf : gb + r * coutf;
    uint4 pack;
    __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&pack);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      v[u] = __float2bfloat16(c + u < w ? src[c + u] : 0.0f);
    *reinterpret_cast<uint4*>(dst + c) = pack;
  }
}

// -- 2. search ---------------------------------------------------------------

// Block (row block t, offset k): map[k][j] = the input row matching output
// row j for offset k, or -1; cnt[k][t] = the block's matches.
__global__ void __launch_bounds__(ROWS) search_kernel(
    const int* __restrict__ in_keys, const int* __restrict__ out_coords,
    const unsigned char* __restrict__ out_valid, int* __restrict__ map,
    int* __restrict__ cnt, int n_in, int n_out, const Geom g) {
  const int t = blockIdx.x, k = blockIdx.y, j = t * ROWS + threadIdx.x;
  int coord[4];
  sparse_conv::load_coord(coord, j, n_out, out_coords, out_valid);
  const int f = sparse_conv::find_neighbor(coord, k, g, in_keys, n_in);
  if (j < n_out) map[(size_t)k * n_out + j] = f;
  const int n = __syncthreads_count(f >= 0);
  if (threadIdx.x == 0) cnt[k * gridDim.x + t] = n;
}

// -- 3. scan -----------------------------------------------------------------

// off[e] = sum of cnt[0..e) for e in [0, m], in one block: each thread sums
// a contiguous run, the runs' sums are scanned across the block.
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(
    const int* __restrict__ cnt, int* __restrict__ off, int m) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (m + SCAN_THREADS - 1) / SCAN_THREADS;
  const int b = min(m, tid * per), e = min(m, b + per);
  int s = 0;
  for (int i = b; i < e; ++i) s += cnt[i];
  int x = s;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int run = x - s + (warp ? warp_sum[warp - 1] : 0);
  for (int i = b; i < e; ++i) {
    off[i] = run;
    run += cnt[i];
  }
  if (tid == SCAN_THREADS - 1) off[m] = run;
}

// -- 4. compaction -----------------------------------------------------------

// Block (row block t, offset k): its matched rows' pairs (i, j) at
// off[k][t] onwards, in ascending j.
__global__ void __launch_bounds__(ROWS) compact_kernel(
    const int* __restrict__ map, const int* __restrict__ cnt,
    const int* __restrict__ off, int* __restrict__ pair_in,
    int* __restrict__ pair_out, int n_out) {
  __shared__ int warp_n[ROWS / 32];
  const int t = blockIdx.x, k = blockIdx.y, e = k * gridDim.x + t;
  if (cnt[e] == 0) return;
  const int j = t * ROWS + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = j < n_out ? map[(size_t)k * n_out + j] : -1;
  const unsigned ball = __ballot_sync(0xffffffffu, f >= 0);
  if (lane == 0) warp_n[warp] = __popc(ball);
  __syncthreads();
  if (f >= 0) {
    int pos = off[e] + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) pos += warp_n[w];
    pair_in[pos] = f;
    pair_out[pos] = j;
  }
}

// -- 5. GEMM -----------------------------------------------------------------

// The GEMM's tile: M = Cin (BI), N = Cout (BO), depth = pairs (BD a ring
// stage).  8 warps as WM x WN warp tiles of WTM x WTN, and WK groups of
// warps splitting each stage's depth where WM * WN < 8.
template <int BI, int BO>
struct Tile {
  static constexpr int WTM = 32;
  static constexpr int WTN = BI * BO > 128 * 64 ? 64 : 32;
  static constexpr int WM = BI / WTM, WN = BO / WTN;
  static constexpr int WK = 8 / (WM * WN);
  static constexpr int BD = WK == 8 ? 128 : 64;
  static constexpr int KSTEPS = BD / 16 / WK;  // k16 steps a warp, a stage
  static constexpr int A_ELEMS = BD * BI, STAGE_ELEMS = BD * (BI + BO);
  static constexpr int STAGE_BYTES = STAGE_ELEMS * 2;
  static constexpr int STAGES = STAGE_BYTES > 24576 ? 3 : 4;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int LDC = BO + 8;  // fp32 epilogue row, conflict-free
  static constexpr int C_BYTES = WK * BI * LDC * 4;
  static constexpr int SMEM = RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES;
  static constexpr int A_ITERS = BD * (BI / 8) / NTHREADS;
  static constexpr int G_ITERS = BD * (BO / 8) / NTHREADS;
  static_assert(WM * WN * WK == 8 && A_ITERS >= 1 && G_ITERS >= 1, "tile");
};

// Block (tile, offset k, split s): dst[k] (dW, or partial s) over the
// block's Cin x Cout tile = sum over its pairs q of fb[pair_in[q]]^T .
// gb[pair_out[q]].  Offset k's chunks of BD pairs are shared out to the S
// splits in contiguous runs.
template <int BI, int BO>
__global__ void __launch_bounds__(NTHREADS, 2) gemm_kernel(
    const __nv_bfloat16* __restrict__ fb,
    const __nv_bfloat16* __restrict__ gb, const int* __restrict__ pair_in,
    const int* __restrict__ pair_out, const int* __restrict__ off,
    float* __restrict__ out, int cin, int cinf, int cout, int coutf,
    int row_blocks, int n_k) {
  using T = Tile<BI, BO>;
  constexpr int STAGES = T::STAGES, BD = T::BD;
  constexpr int NJ = T::WTN / 8;  // n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_co = (cout + BO - 1) / BO;
  const int ci0 = (blockIdx.x / n_co) * BI, co0 = (blockIdx.x % n_co) * BO;
  const int k = blockIdx.y, s = blockIdx.z, splits = gridDim.z;
  const int beg = off[k * row_blocks], end = off[(k + 1) * row_blocks];
  const int chunks = (end - beg + BD - 1) / BD;
  const int per = (chunks + splits - 1) / splits;
  const int c0 = min(chunks, s * per), steps = min(chunks, c0 + per) - c0;
  const int q0 = beg + c0 * BD, q1 = min(end, q0 + steps * BD);
  float* dst = out + ((size_t)s * n_k + k) * cin * cout;
  // dst[ci0 + r][co0 + c] = v(r, c) over the block's tile
  auto store = [&](auto v) {
    for (int e = tid; e < BI * BO; e += NTHREADS) {
      const int r = e / BO, c = e - r * BO;
      if (ci0 + r < cin && co0 + c < cout)
        dst[(size_t)(ci0 + r) * cout + co0 + c] = v(r, c);
    }
  };
  if (steps == 0) {  // no pair in this split
    store([](int, int) { return 0.0f; });
    return;
  }

  // the pair rows of one step, prefetched into registers a step ahead
  int ia[T::A_ITERS], ig[T::G_ITERS];
  auto fetch = [&](int st) {
    const int qb = q0 + st * BD;
#pragma unroll
    for (int u = 0; u < T::A_ITERS; ++u) {
      const int q = qb + (tid + u * NTHREADS) / (BI / 8);
      ia[u] = st < steps && q < q1 ? __ldg(pair_in + q) : -1;
    }
#pragma unroll
    for (int u = 0; u < T::G_ITERS; ++u) {
      const int q = qb + (tid + u * NTHREADS) / (BO / 8);
      ig[u] = st < steps && q < q1 ? __ldg(pair_out + q) : -1;
    }
  };
  // step st's gathered rows as one cp.async group (empty past the last);
  // a pair past the split's end, or a chunk past the padded width, is zero
  auto issue = [&](int st) {
    if (st < steps) {
      __nv_bfloat16* sA = ring + (st % STAGES) * T::STAGE_ELEMS;
      __nv_bfloat16* sG = sA + T::A_ELEMS;
#pragma unroll
      for (int u = 0; u < T::A_ITERS; ++u) {
        const int e = tid + u * NTHREADS, row = e / (BI / 8), seg = e % (BI / 8);
        const int ch = ci0 + seg * 8;
        const bool ok = ia[u] >= 0 && ch < cinf;
        cp_async16(smem_u32(sA + row * BI + swizzle<BI / 8>(row, seg) * 8),
                   ok ? fb + (size_t)ia[u] * cinf + ch : fb, ok ? 16 : 0);
      }
#pragma unroll
      for (int u = 0; u < T::G_ITERS; ++u) {
        const int e = tid + u * NTHREADS, row = e / (BO / 8), seg = e % (BO / 8);
        const int ch = co0 + seg * 8;
        const bool ok = ig[u] >= 0 && ch < coutf;
        cp_async16(smem_u32(sG + row * BO + swizzle<BO / 8>(row, seg) * 8),
                   ok ? gb + (size_t)ig[u] * coutf + ch : gb, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int wk = warp / (T::WM * T::WN), wmn = warp % (T::WM * T::WN);
  const int wm = wmn % T::WM, wn = wmn / T::WM;
  float acc[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    fetch(st);
    issue(st);
  }
  fetch(STAGES - 1);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();  // step st has landed ...
    __syncthreads();  // ... for every thread; slot (st - 1) % STAGES is free
    issue(st + STAGES - 1);
    fetch(st + STAGES);  // in flight during the product
    const __nv_bfloat16* sA = ring + (st % STAGES) * T::STAGE_ELEMS;
    const __nv_bfloat16* sG = sA + T::A_ELEMS;
#pragma unroll
    for (int u = 0; u < T::KSTEPS; ++u) {
      const int kk = (wk * T::KSTEPS + u) * 16;
      // A = f^T (M = Cin, K = pairs) from the [pair][Cin] tile, transposed:
      // lane l addresses pair row kk + (l & 7) + 8 * (l >> 4) at Cin
      // column 8 * ((l >> 3) & 1) of the m16 tile
      uint32_t a[2][4];
      const int ka = kk + (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int chunk = (wm * T::WTM + mi * 16) / 8 + ((lane >> 3) & 1);
        ldmatrix_x4_trans(
            a[mi], smem_u32(sA + ka * BI + swizzle<BI / 8>(ka, chunk) * 8));
      }
      const int kb = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        const int chunk = (wn * T::WTN + jp * 16) / 8 + (lane >> 4);
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_u32(sG + kb * BO + swizzle<BO / 8>(kb, chunk) * 8));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][2 * jp], a[mi], b[0], b[1]);
          mma_16816(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

  // each depth group's accumulators to shared memory, then the groups
  // summed in order 0..WK-1
  float* sC = reinterpret_cast<float*>(smem);
  const int g4 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * T::WTM + mi * 16 + g4 + h * 8;
        const int col = wn * T::WTN + j * 8 + t2;
        *reinterpret_cast<float2*>(sC + (wk * BI + row) * T::LDC + col) =
            make_float2(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]);
      }
  __syncthreads();
  store([&](int r, int c) {
    float v = sC[r * T::LDC + c];
#pragma unroll
    for (int w = 1; w < T::WK; ++w) v += sC[(w * BI + r) * T::LDC + c];
    return v;
  });
}

// -- 6. reduce ---------------------------------------------------------------

// dw[e] = sum over s of part[s][e], in split order.
__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ dw, long long n,
                              int splits) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int s = 1; s < splits; ++s) v += part[s * n + e];
    dw[e] = v;
  }
}

int grid_1d(long long work, int threads) {
  const long long b = (work + threads - 1) / threads;
  return (int)(b < 1 ? 1 : b > 8192 ? 8192 : b);
}

struct GemmArgs {
  const void *fb, *gb, *pair_in, *pair_out, *off;
  void* out;
  int cin, cinf, cout, coutf, row_blocks, k, splits;
};

template <int BI, int BO>
int launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  using T = Tile<BI, BO>;
  auto kernel = gemm_kernel<BI, BO>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((a.cin + BI - 1) / BI) * ((a.cout + BO - 1) / BO), a.k,
                  a.splits);
  kernel<<<grid, NTHREADS, T::SMEM, stream>>>(
      (const __nv_bfloat16*)a.fb, (const __nv_bfloat16*)a.gb,
      (const int*)a.pair_in, (const int*)a.pair_out, (const int*)a.off,
      (float*)a.out, a.cin, a.cinf, a.cout, a.coutf, a.row_blocks, a.k);
  return (int)cudaGetLastError();
}

int launch_gemm_tile(int bi, int bo, const GemmArgs& a, cudaStream_t s) {
  switch (bi * 1000 + bo) {
    case 32032: return launch_gemm<32, 32>(a, s);
    case 32064: return launch_gemm<32, 64>(a, s);
    case 32128: return launch_gemm<32, 128>(a, s);
    case 64032: return launch_gemm<64, 32>(a, s);
    case 64064: return launch_gemm<64, 64>(a, s);
    case 64128: return launch_gemm<64, 128>(a, s);
    case 128032: return launch_gemm<128, 32>(a, s);
    case 128064: return launch_gemm<128, 64>(a, s);
    case 128128: return launch_gemm<128, 128>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fused_sparse_conv_dw

using namespace fused_sparse_conv_dw;

// Launch the passes on `stream` (see the header); returns the first error,
// or cudaGetLastError() after the last launch.  feat fp32 [n_in, cin], grad
// fp32 [n_out, cout], in_keys int32 [n_in] (sorted, INT32_MAX on padding
// rows), out_coords int32 [n_out, 4], out_valid bool [n_out]; dw fp32 [k,
// cin, cout] (written whole, no zeroing needed).  Buffers (device, written
// here): fb bf16 [n_in, cin rounded up to 8], gb bf16 [n_out, cout rounded
// up to 8], map and the pair lists pair_in, pair_out int32 [k * n_out],
// cnt int32 [k * row_blocks], off int32 [k * row_blocks + 1] (row_blocks =
// ceil(n_out / 256)), partial fp32 [splits, k, cin, cout] (unused with
// splits 1).  offs [k*3], s_in [3] and cells [3] are host arrays; (bi, bo)
// the GEMM tile and splits S (`ops/fused_conv.py::dw_tile_shape`,
// `dw_splits`); stage a Stage.
extern "C" int fused_sparse_conv_dkernel(
    const void* feat, const void* grad, const void* in_keys,
    const void* out_coords, const void* out_valid, void* dw, void* fb,
    void* gb, void* map, void* cnt, void* off, void* pair_in,
    void* pair_out, void* partial, int n_in, int n_out, int cin, int cout,
    int k, const int* offs, const int* s_in, const int* cells, int bi,
    int bo, int splits, int stage, void* stream) {
  if (k < 1 || k > sparse_conv::MAX_K || n_in < 1 || n_out < 1 || cin < 1 ||
      cout < 1 || splits < 1 || splits > 65535 || stage < kFull ||
      stage > kPairs || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cinf = (cin + 7) / 8 * 8, coutf = (cout + 7) / 8 * 8;
  cast_kernel<<<grid_1d((long long)n_in * (cinf / 8) +
                            (long long)n_out * (coutf / 8), 256),
                256, 0, s>>>((const float*)feat, (__nv_bfloat16*)fb, n_in,
                             cin, cinf, (const float*)grad,
                             (__nv_bfloat16*)gb, n_out, cout, coutf);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || stage == kCast) return rc;

  const Geom g = sparse_conv::make_geom(k, offs, s_in, cells);
  const int row_blocks = (n_out + ROWS - 1) / ROWS;
  const dim3 rgrid(row_blocks, k);
  search_kernel<<<rgrid, ROWS, 0, s>>>(
      (const int*)in_keys, (const int*)out_coords,
      (const unsigned char*)out_valid, (int*)map, (int*)cnt, n_in, n_out, g);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>((const int*)cnt, (int*)off,
                                         k * row_blocks);
  compact_kernel<<<rgrid, ROWS, 0, s>>>((const int*)map, (const int*)cnt,
                                        (const int*)off, (int*)pair_in,
                                        (int*)pair_out, n_out);
  rc = (int)cudaGetLastError();
  if (rc != 0 || stage == kPairs) return rc;

  const GemmArgs a{fb, gb, pair_in, pair_out, off,
                   splits > 1 ? partial : dw, cin, cinf, cout, coutf,
                   row_blocks, k, splits};
  rc = launch_gemm_tile(bi, bo, a, s);
  if (rc != 0 || splits == 1) return rc;
  const long long n = (long long)k * cin * cout;
  reduce_kernel<<<grid_1d(n, 256), 256, 0, s>>>((const float*)partial,
                                                (float*)dw, n, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sparse_conv_dw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
