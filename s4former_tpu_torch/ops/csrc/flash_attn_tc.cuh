// Building blocks of the bf16 tensor-core flash-attention kernels
// (flash_attn_fwd.cu, and the fused backward in flash_attn_bwd.cu), for
// Hopper (sm_90a), as inline PTX:
//
//   cp.async     16-byte (and 4-byte) asynchronous copies global -> shared,
//                with the zero-fill form for rows past L, commit and wait
//   ldmatrix     8x8 b16 matrices shared -> registers, plain and .trans
//   mma.sync     m16n8k16, bf16 operands, f32 accumulation
//   red.global   vector f32 add (sm_90, PTX ISA 8.1)
//
// Tiles in shared memory are [rows][64] bf16: 128 bytes a row, 8 chunks of
// 16 bytes. Chunk c of row r is stored at chunk c ^ (r & 7), so the eight
// row addresses of one ldmatrix matrix (8 rows, one chunk) fall in eight
// different bank groups, and so do the 16-byte cp.async writes.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t):
//   A 16x16: a0 (row g,   cols 2t..2t+1)   a1 (row g+8, cols 2t..2t+1)
//            a2 (row g,   cols 2t+8..)     a3 (row g+8, cols 2t+8..)
//   B 16x8:  b0 (rows 2t..2t+1, col g)     b1 (rows 2t+8.., col g)
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1) c2, c3 (row g+8, same cols)
// so the C fragments of two neighbouring 8-column tiles, rounded to bf16
// in pairs, are the A fragment of one 16-deep step (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace s4tc {

constexpr int kTileDim = 64;                  // rows of a tile, head dim
constexpr int kTileElems = kTileDim * kTileDim;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, col) in a swizzled [rows][64] bf16 tile
__device__ __forceinline__ int swz(int row, int col) {
  return row * kTileDim + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// 16 bytes global -> shared; with valid false nothing is read and the 16
// bytes are zero (src must still be a mapped address)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0+63 of a [*, 64] bf16 operand (row stride in elements,
// a multiple of 8) into a swizzled tile; rows past L are zero-filled
template <int kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t row_stride, int row0,
                                                int L) {
  static_assert(kTileDim * 8 % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kTileDim * 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 3;
    const int c = i & 7;
    const int row = row0 + r;
    const bool ok = row < L;
    const __nv_bfloat16* g =
        src + static_cast<int64_t>(ok ? row : 0) * row_stride + c * 8;
    cp_async_16(smem_u32(dst + r * kTileDim + ((c ^ r) & 7) * 8), g, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Lane addresses of one ldmatrix.x4 in a swizzled tile. Each names the
// 16-byte row of its lane's matrix (lanes 8i .. 8i+7 give matrix i).
//
// A operand, 16 rows x 16 deep, from a [row][k] tile: matrices
// (rows +0, k +0), (rows +8, k +0), (rows +0, k +8), (rows +8, k +8)
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* tile,
                                           int row0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(tile + swz(row0 + (lane & 15), k0 + ((lane >> 4) << 3)));
}

// B operands of two 8-column tiles n0.., n0+8.., 16 deep, from a [n][k]
// tile (plain ldmatrix): r0, r1 = b0, b1 of n0; r2, r3 = b0, b1 of n0+8
__device__ __forceinline__ uint32_t b_addr_nk(const __nv_bfloat16* tile,
                                              int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                             k0 + (((lane >> 3) & 1) << 3)));
}

// the same from a [k][n] tile (ldmatrix.trans)
__device__ __forceinline__ uint32_t b_addr_kn(const __nv_bfloat16* tile,
                                              int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(tile + swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                             n0 + ((lane >> 4) << 3)));
}

// A operand (16 rows x 16 deep) from a [k][row] tile (ldmatrix.trans)
__device__ __forceinline__ uint32_t a_addr_t(const __nv_bfloat16* tile,
                                             int row0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(tile + swz(k0 + (lane & 7) + ((lane >> 4) << 3),
                             row0 + (((lane >> 3) & 1) << 3)));
}

// d += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// C fragments of 8 neighbouring 8-column tiles as the A fragments of four
// 16-deep steps, rounded to bf16
__device__ __forceinline__ void c_to_a(const float (&c)[8][4],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// *p += (a, b, c, d) in one vector reduction; p 16-byte aligned
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

}  // namespace s4tc
