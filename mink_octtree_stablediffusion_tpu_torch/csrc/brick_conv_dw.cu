// Dense-volume (brick) conv weight gradient (dW, B6) for Hopper (sm_90a):
// a flag for each tile whose cotangent is nonzero, then a pipelined bf16
// tensor-core GEMM over the flagged tiles with fp32 accumulation and a
// deterministic split reduction.
//
// Replaces the TPU kernel `ops/vol_conv.py::vol_conv_dw` (`_dw_kernel`,
// Pallas `pallas_call`) of the JAX package, the dW half of the brick
// route's backward (`_brick_bwd`):
//   dW[k, Cin, Cout] = sum_p bf16(vol[p + delta_k])^T . bf16(g[p])
// over the interior cells p, from the forward's padded input volume and
// the padded cotangent volume that the dF pass also reads
// (`brick_common.cuh`), fp32 result.  Read as 27 GEMMs A_k^T . G: M = Cin,
// N = Cout, the depth every cell of the volume.  Its plain version is
// `ops/vol_conv.py::_vol_conv_dw_plain`.
//
// What bounds it on the H100: the dense work, 2 * 27 * cells * Cin * Cout
// operations, at 128 -> 128 (0.94 ms at the bf16 peak on 4 x 64^3 cells);
// the bytes (both volumes read once) at narrow widths; at 4 -> 4 the
// launches and the host path.  Most tiles of an octree level are empty,
// so the work done is the occupied tiles' share of the dense work.  The
// first design ran a block per (16-channel Cin chunk, Cout tile, run of
// tiles) that loaded each tile synchronously between barriers, multiplied
// with wmma and added its sums into a zeroed dW with fp32 atomics (a
// result that changed from run to run).  This design runs up to three
// passes from one host call, on one stream:
//   1. live (`live_kernel`): one block per 4 x 4 x 16-cell tile reads the
//      tile's cotangent (the conv's Cout channels) once and flags the tile
//      if a bit of it is nonzero (plain version: `ops/vol_conv.py::
//      live_tiles`), so the GEMM's depth is the occupied tiles only, and
//      no empty tile is loaded;
//   2. GEMM (`gemm_kernel`): one 384-thread block (3 warpgroups) per (dx
//      plane, 64-channel Cin tile, 64-channel Cout tile, split) counts the
//      flags (a block-wide scan), takes its split's contiguous run of the
//      live tiles in ascending order, and walks it through a ring of 2
//      stages filled by TMA (one thread issues a tile's 2 tensor-map
//      copies, and an `mbarrier` counts their bytes): the 4 x 6 x 18 halo
//      cells its dx plane reads at its 64 Cin channels, and the tile's 256
//      cotangent rows at its 64 Cout channels, rows of 128 bytes in the
//      128-byte swizzle; tile t + 1 loads while tile t multiplies.  Warpgroup dy
//      owns the taps (dx, dy, dz), dz = 0..2, as D[Cout][Cin] += g^T . halo
//      on Hopper's warpgroup tensor-core instruction, `wgmma.mma_async`
//      m64n64k16 (fp32 accumulators in registers, 96 a thread): per z-run
//      of 16 cells each warp loads its 16 Cout rows of A = g^T once
//      (`ldmatrix.trans`) for the three taps, and the tensor cores read B,
//      the halo rows shifted by the tap, straight from the stage through a
//      matrix descriptor (MN-major: the channels contiguous; one address
//      per tap, no im2col copy); the A of run r + 1 loads while run r
//      multiplies.  A stage whose halo part is all zero (B5's skip of dead
//      chunks, `brick_conv.cu`) is found by one `__syncthreads_or` and not
//      multiplied.  The epilogue stores the registers once: into dW with
//      one split, else into the block's float32 partial [split][27][Cin]
//      [Cout];
//   3. reduce (`reduce_kernel`), with S > 1 splits only: dW = the partials
//      summed in split order.  No atomics and no zero fill: a block with
//      no tile writes zeros, and dW is the same bit for bit from launch to
//      launch (the split count is a pure function of the shape).
// The split taken, and why: one dx plane (9 taps) a block, so that both
// wgmma dimensions are 64 wide.  All 27 taps at 64 x 64 would be 110,592
// accumulators, more than a block's registers hold; keeping 27 taps forces
// N = 16 Cin channels, and m64n16k16 products ran no faster than
// `mma.sync` on this kernel.  The price is bytes: at 128 -> 128 a tile's
// cotangent is loaded once per (dx plane, Cin tile), 6 times, and its halo
// once per Cout tile (1.06 MB a tile in all, L2 hits: a split's blocks walk
// the same tiles at the same time).  Fed by 16-byte `cp.async` copies
// with per-thread addresses, the ring starved the tensor cores (the loads
// alone took longer than the products); TMA is what feeds it.
// Splits (`ops/vol_conv.py::dw_splits`): enough for one wave of blocks on
// the card's 132 SMs, at most one a tile and float32 partials of 16 MiB
// (9 at 128 -> 128: 108 blocks).
// Volumes: both are read through the 1-cell zero shell (a cotangent tile
// past the volume's edge reads the shell, zero by the layout, and TMA fills
// boxes past the padded volume, and channels past the volume's, with
// zeros).
// Host: one ctypes call launches the passes; the tensor maps are encoded
// by the driver's cuTensorMapEncodeTiled (found through the runtime, no
// libcuda link) and the last few kept; the shared memory attribute is set
// once per device.
// What is left: a warp-specialised producer and a deeper ring (a stage is
// 86 KB); the 12-byte spill at 168 registers.
//
// Float32 compute (B6-f32, `brick_conv_dkernel_f32`): both volumes are
// split into three bf16 terms (`brick_common.cuh::split_volume`), and the
// GEMM walks each live tile once per product of terms with indices adding
// up to at most 2 (6 stages a tile, the ring and its TMA copies as at
// bf16).  A second set of fp32 sums per stage (`part`) would not fit
// beside 96 accumulators in 384 threads' registers, so a float32 block
// owns one dz tap of its dx plane (a block per (dx, dz, Cin tile, Cout
// tile, split): 32 + 32 sums a thread) and reads the plane's halo part
// for its one tap.  The ordered split reduce and the absence of atomics
// are those of the bf16 instantiation.
//
// Stages (`stage`): kFull runs every pass; kLive stops after the live
// pass, so that a card test can hold the flags against their plain
// version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "brick_common.cuh"
#include "hopper_mma.cuh"

// A named namespace: a profile finds every pass of B6 by "brick_conv_dw::".
namespace brick_conv_dw {

using namespace brick;
using namespace hopper;

constexpr int NWARPS = 12;  // a GEMM block: 3 warpgroups
constexpr int NTHREADS = NWARPS * 32;
constexpr int CELLS = TX * TY * TZ;  // 256 cells of a tile
constexpr int MAX_DEVICES = 64;

enum Stage { kFull = 0, kLive = 1 };

// -- 1. live -----------------------------------------------------------------

// Block t: flag[t] = whether the tile's cotangent, channels [0, cout) of
// its cells inside the volume, holds a nonzero bit.
__global__ void __launch_bounds__(CELLS) live_kernel(
    const __nv_bfloat16* __restrict__ gvol, unsigned char* __restrict__ flag,
    int x, int y, int z, int gs, int cout) {
  const Tile o = tile_origin(blockIdx.x, x, y, z);
  const int nv = (cout + 7) / 8;  // 16-byte chunks of a cell
  bool nz = false;
  for (int e = threadIdx.x; e < CELLS * nv; e += CELLS) {
    const int cell = e / nv, v = e - cell * nv;
    const int gz = o.z0 + cell % TZ, gy = o.y0 + (cell / TZ) % TY;
    const int gx = o.x0 + cell / (TZ * TY);
    if (gx < x && gy < y && gz < z) {
      uint4 q = __ldg(reinterpret_cast<const uint4*>(
                          gvol + padded_cell(o.b, gx + 1, gy + 1, gz + 1, x,
                                             y, z) * gs) + v);
      const int past = v * 8 + 8 - cout;  // channels of the chunk past cout
      if (past > 0) {  // keep the low 8 - past bf16 values
        uint32_t* w = &q.x;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int keep = 8 - past - 2 * i;  // values of word i kept
          w[i] &= keep >= 2 ? 0xffffffffu : keep == 1 ? 0x0000ffffu : 0u;
        }
      }
      nz |= (q.x | q.y | q.z | q.w) != 0u;
    }
  }
  const int any = __syncthreads_or(nz);
  if (threadIdx.x == 0) flag[blockIdx.x] = (unsigned char)(any != 0);
}

// -- 2. GEMM -----------------------------------------------------------------

// D[Cout][Cin] += A . B on the tensor cores, `wgmma.mma_async` m64n64k16
// (bf16 x bf16 -> fp32) of one warpgroup: A = g^T, this warp's 16 Cout
// rows x 16 cells in the m16n8k16 A fragment (registers); B = 16 cells x
// 64 Cin channels read from shared memory MN-major (the channels
// contiguous: `imm-trans-b` 1) through a matrix descriptor; d[4j..4j+3] is
// n8 tile j of the warp's m16n8 fragments.
__device__ __forceinline__ void wgmma_m64n64_bmn(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// A block's tile: 64 Cout (the wgmma's M) x 64 Cin (its N) x the 9 taps
// of one dx plane.  A ring stage, filled by two TMA copies (tensor maps
// over the padded volumes, out-of-bounds boxes filled with zeros, rows of
// 64 channels = 128 bytes written with the 128-byte swizzle that `wgmma`
// and `ldmatrix` read): the part of the tile's halo that the dx plane
// reads (halo x in [dx, dx + 4): 4 x 6 x 18 cells) at the block's 64 Cin
// channels, then the tile's 256 cotangent rows at its 64 Cout channels.
constexpr int BO = 64, BI = 64;
constexpr int PCELLS = TX * HY * HZ;            // 432 halo cells, dx plane
constexpr int ROW = 128;                        // bytes: 64 bf16 channels
constexpr int H_BYTES = PCELLS * ROW;           // 55,296
constexpr int G_BYTES = CELLS * ROW;            // 32,768
constexpr int STAGE_BYTES = H_BYTES + G_BYTES;  // a multiple of 1024
constexpr int STAGES = 2;
constexpr int RING_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment

// B's descriptor: MN-major, 128-byte swizzle; 8-cell row groups along K
// 1,024 bytes apart (the N extent, 64, is one swizzle atom wide).  A tap's
// rows start at any cell: the tensor cores, like TMA, take the swizzle from
// the address bits, so the base offset stays 0 (the stage is 1024-aligned).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box of `map` at coordinates (c, z, y, x, b) into shared memory
// at `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int z, int y, int x, int b,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(z), "r"(y), "r"(x),
      "r"(b), "r"(bar)
      : "memory");
}

// Block (dx plane [x dz tap] x Cin tile x Cout tile, split s): dst = dW
// (one split) or partial s, over the block's 9 (or 3) x 64 x 64 slab = the
// sum over the split's live tiles of halo^T . g.  The live tiles, in
// ascending order, are shared out to the splits in contiguous runs.
// Warpgroup dy owns the taps (dx, dy, dz) of the block's ND dz (3 at bf16,
// the whole plane; 1 at float32); warp w of it the Cout rows 16 (w % 4) +
// [0, 16).  Thread 0 issues each stage's two copies.  TV is the operands'
// terms: 1 at bf16; 3 at float32, where a stage is (tile, term pair), the
// halo part of volume term i and the cotangent rows of term j, i + j <= 2
// (the terms stacked as 3b instances of each volume, `nb` = b), and each
// stage's products are summed from zero (`part`) and then added to the
// accumulators, so that no sum on the tensor cores, which truncate as they
// accumulate, runs over more than one tile's 16 k16 products.
template <int TV, int ND>
__global__ void __launch_bounds__(NTHREADS, 1) gemm_kernel(
    const __grid_constant__ CUtensorMap halo_map,
    const __grid_constant__ CUtensorMap grad_map,
    const unsigned char* __restrict__ flag, float* __restrict__ out, int x,
    int y, int z, int nb, int tiles, int cin, int cout) {
  constexpr int NP = n_pairs<TV, TV>();
  extern __shared__ unsigned char smem[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ci = (cin + BI - 1) / BI, n_co = (cout + BO - 1) / BO;
  const int plane = blockIdx.x / (n_ci * n_co);  // dx (x dz block)
  const int dx = plane / (3 / ND), dz0 = plane % (3 / ND) * ND;
  const int ci0 = (blockIdx.x / n_co) % n_ci * BI;
  const int co0 = (blockIdx.x % n_co) * BO;
  const int s = blockIdx.y, splits = gridDim.y;

  // the split's run of the live tiles: every block counts the flags (each
  // thread a contiguous run, scanned across the block), takes the ranks
  // [i0, i0 + steps) of split s and finds the first one's tile; thread 0
  // walks the flags on from there
  __shared__ int warp_sum[NWARPS];
  __shared__ int first;
  const int per_t = (tiles + NTHREADS - 1) / NTHREADS;
  const int f0 = min(tiles, tid * per_t), f1 = min(tiles, f0 + per_t);
  int cnt = 0;
  for (int i = f0; i < f1; ++i) cnt += __ldg(flag + i);
  int v = cnt;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NWARPS ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < NWARPS) warp_sum[lane] = w;
  }
  __syncthreads();
  const int before = v - cnt + (warp ? warp_sum[warp - 1] : 0);
  const int n_live = warp_sum[NWARPS - 1];
  const int per = (n_live + splits - 1) / splits;
  const int i0 = min(n_live, s * per);
  const int steps = (min(n_live, i0 + per) - i0) * NP;  // (tile, pair)
  if (steps > 0 && before <= i0 && i0 < before + cnt) {
    int r = before, i = f0;
    for (;; ++i)
      if (__ldg(flag + i) && r++ == i0) break;
    first = i;
  }
  __syncthreads();
  int cursor = first;  // thread 0: the tile of the last stage issued

  // stage st: the tile's halo part (padded cells from its origin, x from
  // x0 + dx) and its cotangent rows (padded cells from the origin + 1), of
  // the stage's pair's terms
  auto issue = [&](int st) {
    const int p = st % NP;
    if (st > 0 && p == 0)
      do ++cursor;
      while (!__ldg(flag + cursor));
    int ti = 0, tj = 0;
    pair<TV, TV>(p, ti, tj);
    const Tile o = tile_origin(cursor, x, y, z);
    const uint32_t dst = ring + (st % STAGES) * STAGE_BYTES;
    const uint32_t bar = smem_u32(&full[st % STAGES]);
    mbar_expect(bar, STAGE_BYTES);
    tma_load(dst, &halo_map, ci0, o.z0, o.y0, o.x0 + dx, o.b + ti * nb, bar);
    tma_load(dst + H_BYTES, &grad_map, co0, o.z0 + 1, o.y0 + 1, o.x0 + 1,
             o.b + tj * nb, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && steps > 0) issue(0);

  const int dy = warp / 4, w4 = warp & 3;
  // A of run r: rows (Cout) 16 w4 + [0, 16) x the run's 16 cells, from the
  // swizzled [cell][Cout] rows transposed: lane l addresses cell (l & 7) +
  // 8 (l >> 4) at Cout column 8 ((l >> 3) & 1) of the warp's 16
  auto load_a = [&](uint32_t g0, int run, uint32_t (&a)[4]) {
    const int ka = run * TZ + (lane & 7) + (lane >> 4) * 8;
    ldmatrix_x4_trans(
        a, g0 + ka * ROW + (((w4 * 2 + ((lane >> 3) & 1)) ^ (ka & 7)) << 4));
  };
  float acc[ND][32];  // tap (dx, dy, dz0 + d): m64n64 fragments
  float part[ND][32];  // a float32 stage's products (unused at bf16)
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.0f;
  // where a stage's products go
  auto dst = [&](int d) -> float(&)[32] {
    if constexpr (TV > 1) return part[d];
    else return acc[d];
  };

  for (int st = 0; st < steps; ++st) {
    const uint32_t h0 = ring + (st % STAGES) * STAGE_BYTES;
    mbar_wait(smem_u32(&full[st % STAGES]), (st / STAGES) & 1);
    bool nz = false;  // a nonzero bit in this thread's share of the halo
    for (int e = tid; e < H_BYTES / 16; e += NTHREADS) {
      uint4 v;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(h0 + e * 16));
      nz |= (v.x | v.y | v.z | v.w) != 0u;
    }
    // every thread is done with the other slot (its products waited for)
    const bool part_live = __syncthreads_or(nz);
    if (tid == 0 && st + 1 < steps) issue(st + 1);
    if (!part_live) continue;  // an all-zero halo part adds nothing
    if constexpr (TV > 1) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int i = 0; i < 32; ++i) part[d][i] = 0.0f;
    }
    const uint32_t g0 = h0 + H_BYTES;
    uint32_t a[2][4];  // unrolled: a[cur] stays in its registers while
    load_a(g0, 0, a[0]);  // the asynchronous products read it
#pragma unroll
    for (int run = 0; run < RUNS; ++run) {
      const int cur = run & 1, rx = run / TY, ry = run % TY;
      // B of tap (dx, dy, dz): the halo part's rows from (rx * HY + ry +
      // dy) * HZ + dz on
      const uint32_t c0 = (rx * HY + ry + dy) * HZ + dz0;
#pragma unroll
      for (int d = 0; d < ND; ++d) fence_operands(dst(d));
      wgmma_fence();
#pragma unroll
      for (int d = 0; d < ND; ++d)
        wgmma_m64n64_bmn(dst(d), a[cur], b_desc(h0 + (c0 + d) * ROW));
      wgmma_commit();
      if (run + 1 < RUNS) {
        wgmma_wait<1>();  // run - 1 is done with a[cur ^ 1]
        load_a(g0, run + 1, a[cur ^ 1]);
      }
    }
    wgmma_wait<0>();  // the stage is free once the next barrier passes
#pragma unroll
    for (int d = 0; d < ND; ++d) fence_operands(dst(d));
    if constexpr (TV > 1) {
#pragma unroll
      for (int d = 0; d < ND; ++d)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[d][i] += part[d][i];
    }
  }

  // the accumulators straight from registers: dW[k][ci][co] = D[co][ci]
  // of tap k = (3 dx + dy) 3 + dz, rows (Cout) co0 + 16 w4 + g4 (+ 8),
  // columns (Cin) ci0 + 8j + t2 (+ 1)
  float* res = out + (size_t)s * 27 * cin * cout;
  const int g4 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    float* tap = res + (size_t)((dx * 3 + dy) * 3 + dz0 + d) * cin * cout;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int co = co0 + w4 * 16 + g4 + ((i >> 1) & 1) * 8;
      const int ci = ci0 + (i >> 2) * 8 + t2 + (i & 1);
      if (ci < cin && co < cout) tap[(size_t)ci * cout + co] = acc[d][i];
    }
  }
}

// -- 3. reduce ---------------------------------------------------------------

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

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a padded bf16 volume [b][x + 2][y + 2][z + 2][c] with
// boxes of 64 channels x bz x by x bx cells of one instance.  A map holds
// only the address, the shape and the box, so the last few are kept and
// reused (PyTorch's allocator hands the same addresses out again).
struct MapKey {
  const void* vol;
  int b, x, y, z, c, bz;
  bool operator==(const MapKey& o) const {
    return vol == o.vol && b == o.b && x == o.x && y == o.y && z == o.z &&
           c == o.c && bz == o.bz;
  }
};

bool encode_map(CUtensorMap* map, const void* vol, int b, int x, int y,
                int z, int c, int bz, int by, int bx) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)c, (cuuint64_t)z + 2,
                              (cuuint64_t)y + 2, (cuuint64_t)x + 2,
                              (cuuint64_t)b};
  cuuint64_t strides[4];
  strides[0] = (cuuint64_t)c * 2;
  for (int i = 1; i < 4; ++i) strides[i] = strides[i - 1] * dims[i];
  const cuuint32_t box[5] = {BI, (cuuint32_t)bz, (cuuint32_t)by,
                             (cuuint32_t)bx, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(vol), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool volume_map(CUtensorMap* map, const void* vol, int b, int x, int y, int z,
                int c, int bz, int by, int bx) {
  constexpr int N = 8;
  static MapKey keys[N];
  static CUtensorMap maps[N];
  static int next = 0;
  static std::mutex lock;
  const MapKey key{vol, b, x, y, z, c, bz};
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < N; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  if (!encode_map(map, vol, b, x, y, z, c, bz, by, bx)) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % N;
  return true;
}

// The dynamic shared memory attribute of an instantiation, set once per
// device.
template <int TV, int ND>
cudaError_t smem_attribute() {
  static bool set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!set[dev]) {
    e = cudaFuncSetAttribute(gemm_kernel<TV, ND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RING_BYTES);
    if (e != cudaSuccess) return e;
    set[dev] = true;
  }
  return cudaSuccess;
}

// The GEMM (and, with S > 1 splits, the reduce) of an instantiation over
// volumes of tv * b instances.
template <int TV, int ND>
int run_gemm(const void* vol, const void* gvol, void* dw, const void* flag,
             void* partial, int b, int x, int y, int z, int cs, int gs,
             int cin, int cout, int splits, cudaStream_t s) {
  CUtensorMap halo_map, grad_map;
  if (!volume_map(&halo_map, vol, TV * b, x, y, z, cs, HZ, HY, TX) ||
      !volume_map(&grad_map, gvol, TV * b, x, y, z, gs, TZ, TY, TX))
    return (int)cudaErrorInvalidValue;
  int rc = (int)smem_attribute<TV, ND>();
  if (rc != 0) return rc;
  gemm_kernel<TV, ND>
      <<<dim3(3 / ND * 3 * ((cin + BI - 1) / BI) * ((cout + BO - 1) / BO),
              splits),
         NTHREADS, RING_BYTES, s>>>(
          halo_map, grad_map, (const unsigned char*)flag,
          (float*)(splits > 1 ? partial : dw), x, y, z, b,
          n_tiles(b, x, y, z), cin, cout);
  rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  const long long n = 27LL * cin * cout;
  reduce_kernel<<<grid_1d(n, 256), 256, 0, s>>>((const float*)partial,
                                                (float*)dw, n, splits);
  return (int)cudaGetLastError();
}

bool valid_args(int b, int x, int y, int z, int cs, int gs, int cin,
                int cout, int splits, int stage, const void* partial) {
  return b >= 1 && x >= 1 && y >= 1 && z >= 1 && cin >= 1 && cout >= 1 &&
         cs % CK == 0 && gs % CK == 0 && cin <= cs && cout <= gs &&
         splits >= 1 && splits <= 65535 && stage >= kFull &&
         stage <= kLive && (splits == 1 || partial != nullptr);
}

}  // namespace brick_conv_dw

using namespace brick_conv_dw;

// Launch the passes on `stream` (see the header); returns the first error,
// or cudaGetLastError() after the last launch.  vol bf16 [b, x + 2, y + 2,
// z + 2, cs] (the forward's input), gvol bf16 [b, x + 2, y + 2, z + 2, gs]
// (the cotangent, its shell zero), cs and gs multiples of 16 with cin <=
// cs and cout <= gs, both 16-byte aligned; dw fp32 [27, cin, cout]
// (written whole, no zeroing needed).  Buffers (device, written here):
// flag uint8 [tiles] (tiles = `brick::n_tiles`), partial fp32 [splits,
// 27, cin, cout] (unused with splits 1).  splits S
// (`ops/vol_conv.py::dw_splits`); stage a Stage.
extern "C" int brick_conv_dkernel(const void* vol, const void* gvol, void* dw,
                                  void* flag, void* partial,
                                  int b, int x, int y, int z, int cs, int gs,
                                  int cin, int cout, int splits,
                                  int stage, void* stream) {
  if (!valid_args(b, x, y, z, cs, gs, cin, cout, splits, stage, partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  live_kernel<<<n_tiles(b, x, y, z), CELLS, 0, s>>>(
      (const __nv_bfloat16*)gvol, (unsigned char*)flag, x, y, z, gs, cout);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || stage == kLive) return rc;
  return run_gemm<1, 3>(vol, gvol, dw, flag, partial, b, x, y, z, cs, gs,
                        cin, cout, splits, s);
}

// The float32 instantiation (B6-f32): vol and gvol fp32 (shaped as above)
// are split into three bf16 terms each, vterms bf16 [3][b, x + 2, y + 2,
// z + 2, cs] and gterms [3][..., gs]; the live pass reads the cotangent's
// first term (a value whose first term is zero has no other term); then
// the GEMM over the six products of terms, a block per (dx plane, dz tap,
// Cin tile, Cout tile, split).  The rest as `brick_conv_dkernel`.
extern "C" int brick_conv_dkernel_f32(const void* vol, const void* gvol,
                                      void* vterms, void* gterms, void* dw,
                                      void* flag, void* partial, int b,
                                      int x, int y, int z, int cs, int gs,
                                      int cin, int cout, int splits,
                                      int stage, void* stream) {
  if (!valid_args(b, x, y, z, cs, gs, cin, cout, splits, stage, partial))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long cells = (long long)b * (x + 2) * (y + 2) * (z + 2);
  __nv_bfloat16* gt = (__nv_bfloat16*)gterms;
  int rc = split_volume((const float*)gvol, gt, cells * gs, s);
  if (rc != 0) return rc;
  live_kernel<<<n_tiles(b, x, y, z), CELLS, 0, s>>>(
      gt, (unsigned char*)flag, x, y, z, gs, cout);
  rc = (int)cudaGetLastError();
  if (rc != 0 || stage == kLive) return rc;
  rc = split_volume((const float*)vol, (__nv_bfloat16*)vterms, cells * cs, s);
  if (rc != 0) return rc;
  return run_gemm<3, 1>(vterms, gterms, dw, flag, partial, b, x, y, z, cs,
                        gs, cin, cout, splits, s);
}

extern "C" const char* brick_conv_dw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
