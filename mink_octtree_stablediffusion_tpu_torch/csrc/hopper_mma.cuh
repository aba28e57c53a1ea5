// PTX wrappers shared by the pipelined bf16 kernels (`brick_conv.cu`,
// `fused_sparse_conv.cu`, `fused_sparse_conv_dw.cu`, `map_conv.cuh`):
// 16-byte `cp.async` copies into a ring of shared-memory stages, `ldmatrix`
// fragment loads, the warp-level tensor-core product `mma.sync.m16n8k16`
// (bf16 in, fp32 accumulate), and `split`, an fp32 value as bf16 terms.
//
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row major): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//       a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
//   B (16 x 8): b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g);
//   C/D (16 x 8, fp32): d0, d1 = (g, 2t..2t+1), d2, d3 = (g + 8, 2t..).
// `ldmatrix_x4` with lanes 0-15 addressing rows 0-15 at k 0 and lanes
// 16-31 the same rows at k 8 gives A; `ldmatrix_x4_trans` on a [k][n]
// tile, lane l addressing row k = (l & 7) + ((l >> 3) & 1) * 8 at column
// n + (l >> 4) * 8, gives B for the two n8 tiles n and n + 8; on a [k][m]
// tile, lane l addressing row k = (l & 7) + (l >> 4) * 8 at column m +
// ((l >> 3) & 1) * 8 gives A (rows m..m+15) of the tile's transpose.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// x as T bf16 terms, each the rounding of what the earlier ones left:
// t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1).  Three terms hold
// an fp32 value to about 2^-24 of itself, so the products a_i . b_j with
// i + j <= 2 on the bf16 tensor cores, summed in fp32, give an
// fp32-accurate product (the split-term kernels: `map_conv.cuh`,
// `fused_sparse_conv.cu`, `fused_sparse_conv_dw.cu`).
template <int T>
__device__ __forceinline__ void split(float x, __nv_bfloat16 (&t)[T]) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    t[u] = __float2bfloat16_rn(x);
    x -= __bfloat162float(t[u]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `src_bytes` 0 writes zeros and
// reads nothing (`src` must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b on the tensor cores (m16n8k16, bf16 x bf16 -> fp32).
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Physical 16-byte chunk of logical chunk `chunk` in row `row` of a tile
// whose rows hold CPR chunks: the XOR swizzle that puts the 8 rows one
// `ldmatrix` phase reads (8 consecutive rows, one logical chunk) in 8
// different bank groups.
template <int CPR>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  if constexpr (CPR >= 8) return chunk ^ (row & 7);
  else return chunk ^ ((row / (8 / CPR)) % CPR);
}

// fp32 pair store of accumulator columns (col, col + 1) of one row, masked
// at `cout`; the pair store needs an even row length.
__device__ __forceinline__ void store_pair(float* __restrict__ row_ptr,
                                           int col, int cout, float v0,
                                           float v1) {
  if (col + 1 < cout && (cout & 1) == 0) {
    *reinterpret_cast<float2*>(row_ptr + col) = make_float2(v0, v1);
  } else {
    if (col < cout) row_ptr[col] = v0;
    if (col + 1 < cout) row_ptr[col + 1] = v1;
  }
}


// -- warpgroup MMA (wgmma), A from registers, B from shared memory --------
//
// `wgmma.mma_async` m64nNk16 (bf16 x bf16 -> fp32) of one warpgroup (4
// consecutive warps): warp w of the group supplies rows 16w..16w+15 of A
// in the m16n8k16 A fragment (`ldmatrix_x4`), and gets the same rows of D
// as m16n8 fragments side by side: d[4j..4j+3] is n8 tile j.  B (K x N) is
// read from shared memory by the tensor cores through a matrix descriptor
// (`smem_desc`).  The product is asynchronous: `wgmma_fence` before it
// (orders the register writes it reads), `wgmma_commit` after, and
// `wgmma_wait<n>` before its A registers are overwritten or D is read.
// Shared memory written by `cp.async` is made visible to it by
// `fence_async_shared` before the barrier that publishes the stage.

// Descriptor of a K-major operand tile without swizzle: core matrices of 8
// rows (M or N) x 16 bytes (8 K values), each 128 contiguous bytes; `lbo`
// is the byte stride between core matrices adjacent along K, `sbo` along
// M or N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses to accumulators across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D += A . B, m64nNk16; A: this warp's m16k16 fragment, B: descriptor
// of a K-major tile.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

}  // namespace hopper
