// Shared pieces of the rel-pos attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): 64-row tiles of float32 in shared memory, and two
// register-blocked tile products on the CUDA cores.
//
// A block has 256 threads, thread t = (ty, tx) = (t / 16, t % 16). Of a
// 64 x 64 output tile it owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4), so the 16 threads of a row sit in one half-warp and a row
// reduction is four shuffles. Tiles are row-major with a stride of LD = 68
// floats: 16-byte aligned rows, and the float4 reads of neighbouring rows
// fall in different bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_attn {

constexpr int TILE = 64;     // queries or keys per tile
constexpr int HEAD_DIM = 64; // the only head dim the kernels take
constexpr int LD = 68;       // row stride of a shared tile, in floats
constexpr int TILE_FLOATS = TILE * LD;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a [n, 64] matrix of T into a float tile; rows
// at or past n are zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src, int row0,
                                          int n) {
  for (int e = threadIdx.x; e < TILE * HEAD_DIM; e += THREADS) {
    const int r = e / HEAD_DIM;
    const int c = e % HEAD_DIM;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < n ? to_f32(src[(size_t)row * HEAD_DIM + c]) : 0.f;
  }
}

// acc[i][j] += sum_r A[ty + 16 i][r] * B[tx + 16 j][r], r < 64
// (A times B transposed; both tiles row-major, read as float4 along r)
__device__ __forceinline__ void mm_nt(const float* A, const float* B, int ty,
                                      int tx, float acc[4][4]) {
#pragma unroll 2
  for (int r = 0; r < 64; r += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + r);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][j] += sum_r A[ty + 16 i][r] * B[r][tx + 16 j], r < 64
__device__ __forceinline__ void mm_nn(const float* A, const float* B, int ty,
                                      int tx, float acc[4][4]) {
#pragma unroll 2
  for (int r = 0; r < 64; r += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[(r + rr) * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = rr == 0 ? a[i].x : rr == 1 ? a[i].y
                         : rr == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// reductions over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the logit of (query row q, key) before the softmax, as the Pallas kernel
// builds it: (q.k * scale + Bh[q, y_k]) + Bw[q, x_k]
__device__ __forceinline__ float logit(float qk, float scale,
                                       const float* __restrict__ bh_row,
                                       const float* __restrict__ bw_row,
                                       int yk, int xk) {
  return (qk * scale + __ldg(bh_row + yk)) + __ldg(bw_row + xk);
}

}  // namespace flash_attn
