// Tensor-core pieces of the bfloat16 rel-pos attention kernels
// (flash_attn_bwd.cu; flash_attn_fwd.cu takes the packing and exp2):
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), ldmatrix fragment loads,
// cp.async copies with zero fill, and the split of a float32 operand into
// two bfloat16 terms.
//
// Fragment layouts of m16n8k16 for lane = 4 r + c (r < 8, c < 4):
//   A (16 x 16, row): a0 = A[r][2c..2c+1], a1 = A[r+8][2c..], a2 = A[r][2c+8..],
//                     a3 = A[r+8][2c+8..];
//   B (16 x 8, col):  b0 = B[2c..2c+1][r], b1 = B[2c+8..2c+9][r];
//   C (16 x 8):       c0, c1 = C[r][2c..2c+1], c2, c3 = C[r+8][2c..2c+1].
// So the accumulators of two neighbouring 8-column tiles are, packed to
// bf16 pairs, the A operand of the next product over those 16 columns.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace flash_attn {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
// bf16 row stride of a 64 x 64 tile in shared memory: 144 bytes, so the 8
// rows of an ldmatrix fall in different banks and each row is 16-byte
// aligned for cp.async
constexpr int BLD = 64 + 8;
constexpr int BTILE = 64 * BLD;  // bf16 elements of one padded tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo to ~2^-16 relative: hi = bf16(x), lo = bf16(x - hi), both
// packed pairwise as an A-operand register
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x on the special-function unit (relative error ~2^-22; results below
// 2^-126 flush to 0, and 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, lane 4r + c receives row r, columns 2c..2c+1 of each (trans: column
// r, rows 2c..2c+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t d[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t d[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// B fragments of two k-steps (32 columns from col0) of the 8 rows from
// row0 of a padded tile stored [n][k]: {b0, b1} of k-step 0, then of 1
__device__ __forceinline__ void ldb_nk(uint32_t b[4], const bf16* tile,
                                       int row0, int col0, int lane) {
  ldmatrix_x4(b, smem_u32(tile + (row0 + (lane & 7)) * BLD + col0 +
                          (lane >> 3) * 8));
}

// B fragments of one k-step (16 rows from row0) and two 8-column n-tiles
// (from col0) of a padded tile stored [k][n]: {b0, b1} of n-tile 0, then 1
__device__ __forceinline__ void ldb_kn(uint32_t b[4], const bf16* tile,
                                       int row0, int col0, int lane) {
  ldmatrix_x4_trans(b, smem_u32(tile + (row0 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * BLD +
                                col0 + (lane >> 4) * 8));
}

// 16- and 4-byte asynchronous copies; a copy that is not valid writes zeros
// and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + 64) of a [n, 64] bf16 matrix into a padded tile, as
// 16-byte cp.async by `threads` threads; rows at or past n are zeros
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int row0, int n, int tid,
                                                int threads) {
  for (int e = tid; e < 64 * 8; e += threads) {
    const int r = e >> 3;
    const int col = (e & 7) * 8;
    const bool ok = row0 + r < n;
    cp_async16(dst + r * BLD + col,
               src + (size_t)(ok ? row0 + r : 0) * 64 + col, ok);
  }
}

// the A fragments of 16 rows (row_lo = r, row_hi = r + 8 of the warp) of a
// [n, 64] bf16 matrix in global memory, 4 k-steps; rows at or past n are 0
__device__ __forceinline__ void load_a_rows(uint32_t a[4][4],
                                            const bf16* __restrict__ m,
                                            const int row[2], int n, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = row[h] < n;
      const bf16* p = m + (size_t)(ok ? row[h] : 0) * 64 + kk * 16 + 2 * c;
      a[kk][h] = ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      a[kk][h + 2] = ok ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
    }
  }
}

}  // namespace flash_attn
