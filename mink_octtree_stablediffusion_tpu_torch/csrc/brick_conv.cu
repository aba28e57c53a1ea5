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

template <int NT>
__global__ void __launch_bounds__(NTHREADS, NT >= 128 ? 1 : 2)
    brick_conv_kernel(const __nv_bfloat16* __restrict__ vol,
                      const __nv_bfloat16* __restrict__ wp,
                      float* __restrict__ out, int x, int y, int z, int cs,
                      int nch, int cout) {
  using L = Layout<NT>;
  constexpr int NF = NT / 8;  // n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sH = sW + STAGES * L::W_STAGE;
  int* sLive = reinterpret_cast<int*>(sH + 2 * L::H_BUF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Tile o = tile_origin(blockIdx.x, x, y, z);
  const int ct = blockIdx.y;

  // 1. the chunks of the conv's channels that hold a nonzero value
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
  const int steps = 3 * sLive[MAX_CHUNKS];  // (live chunk, dx plane)

  // step s: the halo of chunk s / 3 (at its first plane) and the weights
  // of plane s % 3, as one cp.async group (empty past the last step)
  auto load_step = [&](int s) {
    if (s < steps) {
      const int li = s / 3, g = s - 3 * li, c = sLive[li];
      if (g == 0) {
        __nv_bfloat16* hb = sH + (li & 1) * L::H_BUF;
        for (int e = tid; e < HALO * 2; e += NTHREADS) {
          const int cell = e >> 1, h = e & 1;
          const int hz = cell % HZ, hy = (cell / HZ) % HY,
                    hx = cell / (HZ * HY);
          const int px = o.x0 + hx, py = o.y0 + hy, pz = o.z0 + hz;
          const bool in = px < x + 2 && py < y + 2 && pz < z + 2;
          const __nv_bfloat16* src =
              in ? vol + padded_cell(o.b, px, py, pz, x, y, z) * cs +
                       c * CK + h * 8
                 : vol;
          cp_async16(smem_u32(hb + halo_off(cell, h)), src, in ? 16 : 0);
        }
      }
      const __nv_bfloat16* slab =
          wp + (((size_t)ct * nch + c) * 27 + g * TAPS) * L::W_TAP;
      __nv_bfloat16* sw = sW + (s % STAGES) * L::W_STAGE;
      for (int e = tid; e < L::W_STAGE / 8; e += NTHREADS)
        cp_async16(smem_u32(sw + e * 8), slab + e * 8, 16);
    }
    cp_async_commit();
  };

  float acc[RPW][NT / 2];  // m16n8 fragments: acc[r][4j + i] is n8 tile j
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[r][i] = 0.0f;

  load_step(0);
  load_step(1);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();    // step s has landed (s + 1 may be in flight)
    fence_async_shared();  // ... visible to the tensor cores' reads
    __syncthreads();       // ... for every thread; stage (s + 2) % 3 is free
    load_step(s + 2);
    const int li = s / 3, dx = s - 3 * li;
    const __nv_bfloat16* hb = sH + (li & 1) * L::H_BUF;
    const __nv_bfloat16* sw = sW + (s % STAGES) * L::W_STAGE;
    // A of tap t for this warp's z-runs: 16 consecutive halo cells along
    // z, shifted by the tap, one row address per lane
    uint32_t a[2][RPW][4];
    auto load_a = [&](uint32_t(&dst)[RPW][4], int t) {
      const int dy = t / 3, dz = t % 3;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int run = warp * RPW + r, rx = run / TY, ry = run % TY;
        const int cell = ((rx + dx) * HY + ry + dy) * HZ + dz + (lane & 15);
        ldmatrix_x4(dst[r], smem_u32(hb + halo_off(cell, lane >> 4)));
      }
    };
    load_a(a[0], 0);
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      // B of tap t: [NT][16] K-major core matrices (n / 8, k / 8) at
      // ((n / 8) * 2 + k / 8) * 128 bytes
      const uint64_t desc = smem_desc(smem_u32(sw + t * L::W_TAP), 128, 256);
#pragma unroll
      for (int r = 0; r < RPW; ++r) fence_operands(acc[r]);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < RPW; ++r) Wgmma<NT>::mma(acc[r], a[t & 1][r], desc);
      wgmma_commit();
      if (t + 1 < TAPS) {
        wgmma_wait<1>();  // tap t - 1 is done with a[(t + 1) & 1]
        load_a(a[(t + 1) & 1], t + 1);
      }
    }
    wgmma_wait<0>();  // the stage is free once the barrier above passes
#pragma unroll
    for (int r = 0; r < RPW; ++r) fence_operands(acc[r]);
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
// bf16 [Cout tiles][Cin chunks][27][nt/8][2][8][8], element (t, c, k, nb,
// kb, ni, ki) = W[k][16c + 8kb + ki][nt t + 8nb + ni], zero past Cin and
// Cout; one thread per element.
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
                                   int mirror) {
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
    wp[e] = __float2bfloat16(v);
  }
}

int pack(const void* w, void* wp, int cin, int cout, int nt, int mirror,
         int w_bf16, cudaStream_t stream) {
  const int nch = (cin + CK - 1) / CK, nct = (cout + nt - 1) / nt;
  const int total = nct * nch * 27 * CK * nt;
  const int blocks = total / 256 + 1 < 1024 ? total / 256 + 1 : 1024;
  if (w_bf16)
    pack_weight_kernel<<<blocks, 256, 0, stream>>>(
        (const __nv_bfloat16*)w, (__nv_bfloat16*)wp, cin, cout, nch, nct, nt,
        mirror);
  else
    pack_weight_kernel<<<blocks, 256, 0, stream>>>(
        (const float*)w, (__nv_bfloat16*)wp, cin, cout, nch, nct, nt,
        mirror);
  return (int)cudaGetLastError();
}

template <int NT>
int launch(const void* vol, const void* wp, void* out, int b, int x, int y,
           int z, int cs, int nch, int cout, cudaStream_t stream) {
  const size_t smem = Layout<NT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      brick_conv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles(b, x, y, z), (cout + NT - 1) / NT);
  brick_conv_kernel<NT><<<grid, NTHREADS, smem, stream>>>(
      (const __nv_bfloat16*)vol, (const __nv_bfloat16*)wp, (float*)out, x, y,
      z, cs, nch, cout);
  return (int)cudaGetLastError();
}

bool valid_tile(int nt) { return nt == 16 || nt == 32 || nt == 64 || nt == 128; }

}  // namespace

// Packs the weight alone (the pass `brick_conv_forward` runs first): w
// fp32, or bf16 with w_bf16, [27, cin, cout] ([27, cout, cin], the
// forward's, with mirror), wp bf16 [ceil(cout / nt) * ceil(cin / 16) * 27 *
// 16 * nt].
extern "C" int brick_conv_pack(const void* w, void* wp, int cin, int cout,
                               int nt, int mirror, int w_bf16, void* stream) {
  if (cin < 1 || cout < 1 || !valid_tile(nt)) return (int)cudaErrorInvalidValue;
  return pack(w, wp, cin, cout, nt, mirror, w_bf16, (cudaStream_t)stream);
}

// Launch on `stream`: the weight pack into `wp`, then the conv; returns
// cudaGetLastError() right after the launches.  vol bf16 [b, x + 2, y + 2,
// z + 2, cs] (cs a multiple of 16, at most 1024; 16-byte aligned); w, wp
// as `brick_conv_pack`; out fp32 [b, x, y, z, cout].  nt is the Cout tile:
// 16, 32, 64 or 128.
extern "C" int brick_conv_forward(const void* vol, const void* w, void* wp,
                                  void* out, int b, int x, int y, int z,
                                  int cs, int cin, int cout, int nt,
                                  int mirror, int w_bf16, void* stream) {
  const int nch = (cin + CK - 1) / CK;
  if (b < 1 || x < 1 || y < 1 || z < 1 || cin < 1 || cout < 1 ||
      cs % CK != 0 || nch * CK > cs || nch > MAX_CHUNKS || !valid_tile(nt))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = pack(w, wp, cin, cout, nt, mirror, w_bf16, s);
  if (rc != 0) return rc;
  switch (nt) {
    case 16: return launch<16>(vol, wp, out, b, x, y, z, cs, nch, cout, s);
    case 32: return launch<32>(vol, wp, out, b, x, y, z, cs, nch, cout, s);
    case 64: return launch<64>(vol, wp, out, b, x, y, z, cs, nch, cout, s);
    default: return launch<128>(vol, wp, out, b, x, y, z, cs, nch, cout, s);
  }
}

extern "C" const char* brick_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
