// Dense-volume (brick) k=3 s=1 conv for Hopper (sm_90a): bf16 tensor-core
// implicit GEMM with fp32 accumulation, forward and dF.
//
// Replaces the TPU kernel `ops/vol_conv.py::vol_conv_tiles` (`_kernel`,
// Pallas `pallas_call`) of the JAX package, in both of its uses on the
// brick route (`brick_pallas_conv`):
//   - the forward (B5): out[p] = sum_k vol[p + delta_k] . W_k over the 27
//     offsets, on the zero-padded volume the rows were scattered into;
//   - the dF pass: the same conv of the cotangent volume with the
//     mirrored-transposed kernel W'[k] = W[26 - k]^T, applied when the
//     weight is packed (below).
// The TPU's 128-lane channel padding, its z + 8 padding, its VMEM-resident
// z column and its brick-order output are Mosaic mechanics and are not
// carried over: channels are padded to the MMA depth (16), the output is
// a dense fp32 [b, x, y, z, cout] volume.
//
// What bounds it on the H100: the dense work, 2 * 27 * cells * Cin * Cout
// operations, is operation bound at 128 -> 128 (116 GFLOP on 4 x 32^3
// cells, 0.117 ms at the bf16 peak) and byte bound at narrow widths (the
// volume read, the fp32 output written).  The first design lost to
// cuDNN (5.6x at 128 -> 128) because every block re-read and converted
// the fp32 weight slab scalar by scalar, re-loaded the halo for each
// 64-wide Cout tile, and loaded synchronously between its MMAs.  This
// design:
//   - the weight is cast and packed once per launch by a small pass in
//     this file that runs before the conv (`pack_weight_kernel`; its plain
//     version is `ops/vol_conv.py::pack_weight`), bf16 [Cout tiles][Cin
//     chunks][27][NT/8][2][8][8], the mirror applied in the pack for dF:
//     each tap's 16 x NT slab in the K-major core-matrix order the tensor
//     cores read, one ring stage one contiguous slab, loaded with 16-byte
//     `cp.async` copies;
//   - one block covers NT = Cout (up to 128) whole, so each 16-channel
//     chunk of the 6 x 6 x 18 halo is loaded once per tile;
//   - a ring of 3 weight stages, each one dx plane (9 taps x 16 x NT; 36.9
//     KB at NT = 128), and 2 halo buffers: the copies of step s + 2 are in
//     flight while step s multiplies;
//   - the product on Hopper's warpgroup tensor-core instruction,
//     `wgmma.mma_async` m64nNTk16 (`hopper_mma.cuh`): A from registers,
//     loaded by `ldmatrix` as 16 consecutive halo cells along z at the
//     tap's shift (one row address per lane, so no im2col copy; the halo
//     XOR-swizzled by 16-byte halves against bank conflicts), B read by the
//     tensor cores from the stage through a matrix descriptor; the A
//     fragments of tap t + 1 load while tap t's product runs;
//   - a block first scans its halo for the 16-channel chunks that hold a
//     nonzero value and walks only those: an empty tile (most tiles of a
//     sparse octree level) costs one read of its halo and a write of
//     zeros, with no weight traffic.
// What is left: the weights are still read from L2 by every tile (0.9 MB
// a tile at 128 -> 128) and the ring is filled by the same threads that
// multiply (no TMA producer warp); the wrapper's host path (checks, the
// launch) is longer than the kernel at 4 -> 4.
//
// Float32 compute (B5-f32 and its dF pass, `brick_conv_forward_f32`): a
// cast pass (`brick_common.cuh::split_volume`) writes the float32 volume as
// three bf16 volumes, the pack writes three bf16 terms of the weight (one
// of a weight stored in bf16), and the conv walks each live chunk once per
// product of terms whose indices add up to at most 2 (6, or 3): the same
// ring, halo and weight stages as at bf16, so the shared memory is the
// same, but the tile is at most 64 Cout wide (a second set of fp32 sums,
// `part`, sums each step from zero, so that the tensor cores' truncating
// accumulation never runs over more than one step's 9 products).  The
// split runs as a pass of its own, not in shared memory after a float32
// load: the halo path (16-byte `cp.async` of bf16, the swizzle, `ldmatrix`)
// stays the one the bf16 instantiation runs, and B6's TMA copies need bf16
// volumes anyway.
//
// Blocks: one 256-thread block (two warpgroups) per (4 x 4 x 16-cell
// tile, NT-wide Cout tile), NT in {16, 32, 64, 128} after Cout
// (`ops/vol_conv.py::tile_cout`).  Warp w owns z-runs 2w and 2w + 1 (16
// rows each) x NT columns; a warpgroup's product covers its four warps'
// runs of one parity.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "brick_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace brick;
using namespace hopper;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RPW = RUNS / NWARPS;  // z-runs per warp
constexpr int TAPS = 9;             // one dx plane: a ring stage's taps
constexpr int STAGES = 3;           // weight stages in the ring
constexpr int MAX_CHUNKS = 64;      // 16-channel chunks: cs <= 1024

template <int NT>
struct Layout {
  static constexpr int W_TAP = CK * NT;            // bf16 elements of a tap
  static constexpr int W_STAGE = TAPS * W_TAP;     // bf16 elements
  static constexpr int H_BUF = HALO * CK;          // bf16 elements
  static constexpr size_t bytes =
      (size_t)(STAGES * W_STAGE + 2 * H_BUF) * 2 + (MAX_CHUNKS + 1) * 4;
};

// Halo cell `cell`, 8-channel half `h` of a chunk: the halves of cells
// 4..7 mod 8 swap, so any 8 consecutive cells read at one half (one
// `ldmatrix` phase) hit 8 different bank groups.
__device__ __forceinline__ int halo_off(int cell, int h) {
  return (cell * 2 + (h ^ ((cell >> 2) & 1))) * 8;
}

// Volume terms TV and weight terms TW: (1, 1) at bf16 compute; (3, 3) at
// float32 compute, or (3, 1) where the weight is stored in bf16 (which its
// one term holds exactly).  A step is (live chunk, term pair, dx plane):
// the halo of volume term i at the pair's first plane, the weights of
// weight term j at the plane; each float32 step's 9 products are summed
// from zero (`part`) and then added to the accumulators, so that no sum
// on the tensor cores, which truncate as they accumulate, runs over more
// than 9 k16 products.
template <int NT, int TV, int TW>
__global__ void __launch_bounds__(NTHREADS, NT >= 128 || TV > 1 ? 1 : 2)
    brick_conv_kernel(const __nv_bfloat16* __restrict__ vol, size_t vterm,
                      const __nv_bfloat16* __restrict__ wp, size_t wterm,
                      float* __restrict__ out, int x, int y, int z, int cs,
                      int nch, int cout) {
  using L = Layout<NT>;
  constexpr int NF = NT / 8;  // n8 tiles of a warp
  constexpr int NP = n_pairs<TV, TW>();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sH = sW + STAGES * L::W_STAGE;
  int* sLive = reinterpret_cast<int*>(sH + 2 * L::H_BUF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Tile o = tile_origin(blockIdx.x, x, y, z);
  const int ct = blockIdx.y;

  // 1. the chunks of the conv's channels that hold a nonzero value (in
  // term 0: a value whose first term is zero has no other term)
  for (int c = tid; c < nch; c += NTHREADS) sLive[c] = 0;
  __syncthreads();
  const int segs = 2 * nch;  // 16-byte segments of a cell
  for (int e = tid; e < HALO * segs; e += NTHREADS) {
    const int cell = e / segs, q = e - cell * segs;
    const int hz = cell % HZ, hy = (cell / HZ) % HY, hx = cell / (HZ * HY);
    const int px = o.x0 + hx, py = o.y0 + hy, pz = o.z0 + hz;
    if (px < x + 2 && py < y + 2 && pz < z + 2) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          vol + padded_cell(o.b, px, py, pz, x, y, z) * cs) + q);
      if ((v.x | v.y | v.z | v.w) != 0u) sLive[q >> 1] = 1;
    }
  }
  __syncthreads();
  if (tid == 0) {  // compact in place: sLive[0..n) = the live chunks
    int n = 0;
    for (int c = 0; c < nch; ++c)
      if (sLive[c]) sLive[n++] = c;
    sLive[MAX_CHUNKS] = n;
  }
  __syncthreads();
  const int steps = 3 * NP * sLive[MAX_CHUNKS];  // (chunk, pair, dx plane)

  // step s: the halo of chunk s / (3 NP) of the pair's volume term (at its
  // first plane) and the pair's weights of plane s % 3, as one cp.async
  // group (empty past the last step)
  auto load_step = [&](int s) {
    if (s < steps) {
      const int v = s / 3, g = s - 3 * v, li = v / NP;
      int ti = 0, tj = 0;
      pair<TV, TW>(v - li * NP, ti, tj);
      const int c = sLive[li];
      if (g == 0) {
        const __nv_bfloat16* vt = vol + ti * vterm;
        __nv_bfloat16* hb = sH + (v & 1) * L::H_BUF;
        for (int e = tid; e < HALO * 2; e += NTHREADS) {
          const int cell = e >> 1, h = e & 1;
          const int hz = cell % HZ, hy = (cell / HZ) % HY,
                    hx = cell / (HZ * HY);
          const int px = o.x0 + hx, py = o.y0 + hy, pz = o.z0 + hz;
          const bool in = px < x + 2 && py < y + 2 && pz < z + 2;
          const __nv_bfloat16* src =
              in ? vt + padded_cell(o.b, px, py, pz, x, y, z) * cs +
                       c * CK + h * 8
                 : vt;
          cp_async16(smem_u32(hb + halo_off(cell, h)), src, in ? 16 : 0);
        }
      }
      const __nv_bfloat16* slab =
          wp + tj * wterm + (((size_t)ct * nch + c) * 27 + g * TAPS) *
                                L::W_TAP;
      __nv_bfloat16* sw = sW + (s % STAGES) * L::W_STAGE;
      for (int e = tid; e < L::W_STAGE / 8; e += NTHREADS)
        cp_async16(smem_u32(sw + e * 8), slab + e * 8, 16);
    }
    cp_async_commit();
  };

  float acc[RPW][NT / 2];  // m16n8 fragments: acc[r][4j + i] is n8 tile j
  float part[RPW][NT / 2];  // a float32 step's products (unused at bf16)
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[r][i] = 0.0f;
  // where a step's products go
  auto dst = [&](int r) -> float(&)[NT / 2] {
    if constexpr (TV > 1) return part[r];
    else return acc[r];
  };

  load_step(0);
  load_step(1);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();    // step s has landed (s + 1 may be in flight)
    fence_async_shared();  // ... visible to the tensor cores' reads
    __syncthreads();       // ... for every thread; stage (s + 2) % 3 is free
    load_step(s + 2);
    const int v = s / 3, dx = s - 3 * v;
    const __nv_bfloat16* hb = sH + (v & 1) * L::H_BUF;
    const __nv_bfloat16* sw = sW + (s % STAGES) * L::W_STAGE;
    if constexpr (TV > 1) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) part[r][i] = 0.0f;
    }
    // A of tap t for this warp's z-runs: 16 consecutive halo cells along
    // z, shifted by the tap, one row address per lane
    uint32_t a[2][RPW][4];
    auto load_a = [&](uint32_t(&da)[RPW][4], int t) {
      const int dy = t / 3, dz = t % 3;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int run = warp * RPW + r, rx = run / TY, ry = run % TY;
        const int cell = ((rx + dx) * HY + ry + dy) * HZ + dz + (lane & 15);
        ldmatrix_x4(da[r], smem_u32(hb + halo_off(cell, lane >> 4)));
      }
    };
    load_a(a[0], 0);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      // B of tap t: [NT][16] K-major core matrices (n / 8, k / 8) at
      // ((n / 8) * 2 + k / 8) * 128 bytes
      const uint64_t desc = smem_desc(smem_u32(sw + t * L::W_TAP), 128, 256);
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_operands(dst(r));
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < RPW; ++r) Wgmma<NT>::mma(dst(r), a[t & 1][r], desc);
      wgmma_commit();
      if (t + 1 < TAPS) {
        wgmma_wait<1>();  // tap t - 1 is done with a[(t + 1) & 1]
        load_a(a[(t + 1) & 1], t + 1);
      }
    }
    wgmma_wait<0>();  // the stage is free once the barrier above passes
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_operands(dst(r));
    if constexpr (TV > 1) {
#pragma unroll
      for (int r = 0; r < RPW; ++r)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[r][i] += part[r][i];
    }
  }

  // every cell of the tile inside the volume is written, zeros included
  const int g8 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int run = warp * RPW + r;
    const int gx = o.x0 + run / TY, gy = o.y0 + run % TY;
    if (gx >= x || gy >= y) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gz = o.z0 + g8 + half * 8;
      if (gz >= z) continue;
      float* row = out + ((((size_t)o.b * x + gx) * y + gy) * z + gz) * cout;
#pragma unroll
      for (int j = 0; j < NF; ++j)
        store_pair(row, ct * NT + j * 8 + t2, cout, acc[r][4 * j + half * 2],
                   acc[r][4 * j + half * 2 + 1]);
    }
  }
}

// The weight pack (`ops/vol_conv.py::pack_weight` is its plain version):
// W [27, Cin, Cout], fp32 or (parameters stored in bf16) bf16 (for dF,
// `mirror`, the forward's [27, Cout, Cin] read as W'[k] = W[26 - k]^T) ->
// `terms` bf16 terms (`hopper::split`; 1 at bf16 compute or for a bf16
// weight), each [Cout tiles][Cin chunks][27][nt/8][2][8][8], element (t,
// c, k, nb, kb, ni, ki) = W[k][16c + 8kb + ki][nt t + 8nb + ni], zero past
// Cin and Cout, term u at u * total; one thread per element.
__device__ __forceinline__ float load_weight(const float* w, size_t i) {
  return w[i];
}
__device__ __forceinline__ float load_weight(const __nv_bfloat16* w,
                                             size_t i) {
  return __bfloat162float(w[i]);
}

template <typename W>
__global__ void pack_weight_kernel(const W* __restrict__ w,
                                   __nv_bfloat16* __restrict__ wp, int cin,
                                   int cout, int nch, int nct, int nt,
                                   int mirror, int terms) {
  const int total = nct * nch * 27 * CK * nt;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    int q = e;
    const int ki = q & 7, ni = (q >> 3) & 7, kb = (q >> 6) & 1;
    q >>= 7;
    const int nb = q % (nt / 8);
    q /= nt / 8;
    const int k = q % 27;
    q /= 27;
    const int c = q % nch, t = q / nch;
    const int i = c * CK + kb * 8 + ki, j = t * nt + nb * 8 + ni;
    float v = 0.0f;
    if (i < cin && j < cout)
      v = load_weight(w, mirror ? ((size_t)(26 - k) * cout + j) * cin + i
                                : ((size_t)k * cin + i) * cout + j);
    for (int u = 0; u < terms; ++u) {
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      wp[(size_t)u * total + e] = h;
      v -= __bfloat162float(h);
    }
  }
}

int pack(const void* w, void* wp, int cin, int cout, int nt, int mirror,
         int w_bf16, int terms, cudaStream_t stream) {
  const int nch = (cin + CK - 1) / CK, nct = (cout + nt - 1) / nt;
  const int total = nct * nch * 27 * CK * nt;
  const int blocks = total / 256 + 1 < 1024 ? total / 256 + 1 : 1024;
  if (w_bf16)
    pack_weight_kernel<<<blocks, 256, 0, stream>>>(
        (const __nv_bfloat16*)w, (__nv_bfloat16*)wp, cin, cout, nch, nct, nt,
        mirror, terms);
  else
    pack_weight_kernel<<<blocks, 256, 0, stream>>>(
        (const float*)w, (__nv_bfloat16*)wp, cin, cout, nch, nct, nt,
        mirror, terms);
  return (int)cudaGetLastError();
}

template <int NT, int TV, int TW>
int launch(const __nv_bfloat16* vol, size_t vterm, const void* wp,
           void* out, int b, int x, int y, int z, int cs, int nch, int cout,
           cudaStream_t stream) {
  const size_t smem = Layout<NT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      brick_conv_kernel<NT, TV, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nct = (cout + NT - 1) / NT;
  const dim3 grid(n_tiles(b, x, y, z), nct);
  brick_conv_kernel<NT, TV, TW><<<grid, NTHREADS, smem, stream>>>(
      vol, vterm, (const __nv_bfloat16*)wp, (size_t)nct * nch * 27 * CK * NT,
      (float*)out, x, y, z, cs, nch, cout);
  return (int)cudaGetLastError();
}

// The float32 instantiations, by Cout tile and weight terms.
template <int TW>
int launch_f32(const __nv_bfloat16* vt, size_t n, const void* wp, void* out,
               int b, int x, int y, int z, int cs, int nch, int cout, int nt,
               cudaStream_t s) {
  switch (nt) {
    case 16:
      return launch<16, 3, TW>(vt, n, wp, out, b, x, y, z, cs, nch, cout, s);
    case 32:
      return launch<32, 3, TW>(vt, n, wp, out, b, x, y, z, cs, nch, cout, s);
    default:
      return launch<64, 3, TW>(vt, n, wp, out, b, x, y, z, cs, nch, cout, s);
  }
}

bool valid_tile(int nt) { return nt == 16 || nt == 32 || nt == 64 || nt == 128; }

bool valid_args(int b, int x, int y, int z, int cs, int cin, int cout,
                int nt) {
  const int nch = (cin + CK - 1) / CK;
  return b >= 1 && x >= 1 && y >= 1 && z >= 1 && cin >= 1 && cout >= 1 &&
         cs % CK == 0 && nch * CK <= cs && nch <= MAX_CHUNKS && valid_tile(nt);
}

}  // namespace

// Packs the weight alone (the pass `brick_conv_forward` runs first): w
// fp32, or bf16 with w_bf16, [27, cin, cout] ([27, cout, cin], the
// forward's, with mirror), wp bf16 [terms][ceil(cout / nt) * ceil(cin /
// 16) * 27 * 16 * nt], terms 1 or 3.
extern "C" int brick_conv_pack(const void* w, void* wp, int cin, int cout,
                               int nt, int mirror, int w_bf16, int terms,
                               void* stream) {
  if (cin < 1 || cout < 1 || !valid_tile(nt) || (terms != 1 && terms != 3))
    return (int)cudaErrorInvalidValue;
  return pack(w, wp, cin, cout, nt, mirror, w_bf16, terms,
              (cudaStream_t)stream);
}

// The volume split alone (the pass `brick_conv_forward_f32` runs first):
// x fp32 [n] -> out bf16 [3][n], n a multiple of 4.
extern "C" int brick_conv_split(const void* x, void* out, long long n,
                                void* stream) {
  return split_volume((const float*)x, (__nv_bfloat16*)out, n,
                      (cudaStream_t)stream);
}

// Launch on `stream`: the weight pack into `wp`, then the conv; returns
// cudaGetLastError() right after the launches.  vol bf16 [b, x + 2, y + 2,
// z + 2, cs] (cs a multiple of 16, at most 1024; 16-byte aligned); w, wp
// as `brick_conv_pack` with one term; out fp32 [b, x, y, z, cout].  nt is
// the Cout tile: 16, 32, 64 or 128.
extern "C" int brick_conv_forward(const void* vol, const void* w, void* wp,
                                  void* out, int b, int x, int y, int z,
                                  int cs, int cin, int cout, int nt,
                                  int mirror, int w_bf16, void* stream) {
  if (!valid_args(b, x, y, z, cs, cin, cout, nt))
    return (int)cudaErrorInvalidValue;
  const int nch = (cin + CK - 1) / CK;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = pack(w, wp, cin, cout, nt, mirror, w_bf16, 1, s);
  if (rc != 0) return rc;
  const __nv_bfloat16* v = (const __nv_bfloat16*)vol;
  switch (nt) {
    case 16: return launch<16, 1, 1>(v, 0, wp, out, b, x, y, z, cs, nch, cout, s);
    case 32: return launch<32, 1, 1>(v, 0, wp, out, b, x, y, z, cs, nch, cout, s);
    case 64: return launch<64, 1, 1>(v, 0, wp, out, b, x, y, z, cs, nch, cout, s);
    default: return launch<128, 1, 1>(v, 0, wp, out, b, x, y, z, cs, nch, cout, s);
  }
}

// The float32 instantiation (B5-f32, its dF pass with mirror): the volume
// split into `vterms` (bf16 [3][b, x + 2, y + 2, z + 2, cs]), the weight
// packed into `wp` as 3 terms (1 with w_bf16), then the conv; vol fp32
// [b, x + 2, y + 2, z + 2, cs], the rest as `brick_conv_forward`, nt 16,
// 32 or 64.
extern "C" int brick_conv_forward_f32(const void* vol, void* vterms,
                                      const void* w, void* wp, void* out,
                                      int b, int x, int y, int z, int cs,
                                      int cin, int cout, int nt, int mirror,
                                      int w_bf16, void* stream) {
  if (!valid_args(b, x, y, z, cs, cin, cout, nt) || nt > 64)
    return (int)cudaErrorInvalidValue;
  const int nch = (cin + CK - 1) / CK;
  const long long n = (long long)b * (x + 2) * (y + 2) * (z + 2) * cs;
  cudaStream_t s = (cudaStream_t)stream;
  __nv_bfloat16* vt = (__nv_bfloat16*)vterms;
  int rc = split_volume((const float*)vol, vt, n, s);
  if (rc != 0) return rc;
  rc = pack(w, wp, cin, cout, nt, mirror, w_bf16, w_bf16 ? 1 : 3, s);
  if (rc != 0) return rc;
  if (w_bf16)
    return launch_f32<1>(vt, n, wp, out, b, x, y, z, cs, nch, cout, nt, s);
  return launch_f32<3>(vt, n, wp, out, b, x, y, z, cs, nch, cout, nt, s);
}

extern "C" const char* brick_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
