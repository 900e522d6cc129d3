// Attention with the decomposed relative-position bias of the ViTDet global
// blocks, forward, for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes by aldi_tpu_torch/ops/flash_attn_kernel.py.
//
// Replaces the Pallas forward of the JAX package,
// aldi_tpu/ops/pallas_flash_attn.py:222 _attn_fwd (kernel _fwd_kernel :118):
//   out = softmax(q k^T * scale + Bh[q, y_k] + Bw[q, x_k]) v,
//   lse = m + log(den),
// for q/k/v [G, N, 64] (float32 or bfloat16), Bh [G, N, h_grid] and
// Bw [G, N, w_grid] float32, key k at grid cell (y_k, x_k) = (k / w_grid,
// k % w_grid). The bias of a logit is read straight from the query's Bh and
// Bw rows: the one-hot expander matmuls of the TPU kernel exist only
// because Mosaic rejects a lane broadcast.
//
// Design (FlashAttention-2 order): one block per (g, tile of 64 queries)
// walks the tiles of 64 keys with an online softmax (running max,
// denominator, float32 output accumulator in registers). Rounding follows
// the TPU kernel: q.k is a float32 sum of exact products, the
// probabilities are rounded to the input dtype before P.V (bfloat16 there)
// while the denominator sums them unrounded, out is rounded to the input
// dtype once. Ragged tails need no special shapes: keys at or past N get
// probability 0, queries past N are computed on zero rows and not written.
// - bfloat16 (the detector's dtype): 4 warps, 16 queries each, both
//   products on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), Q in registers, the K tile and the transposed V tile in
//   shared memory; P goes from the S accumulators to the A operand of
//   P.V in registers, rounded to bf16 on the way.
// - float32 (the tiny reference detectors): 256 threads, Q, K, V and P as
//   float32 tiles in shared memory, both products on the CUDA cores as
//   register-blocked 4 x 4 micro-tiles (flash_attn_common.cuh).
//
// What bounds it on the card: operations, 4 N^2 64 per (g) (q.k and P.v),
// ~206 GFLOP per image and global block of ViTDet-B at 1024x2048 against
// ~125 MB of inputs and outputs, at the dense bf16 tensor-core peak.
// mma.sync reaches a fraction of it; wgmma with TMA and a pipeline of K/V
// tiles are later work.

#include <cstdint>

#include "flash_attn_common.cuh"

namespace {

using namespace flash_attn;

// ------------------------------------------------- float32, CUDA cores
__global__ void __launch_bounds__(THREADS)
    flash_attn_fwd_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ bh,
                              const float* __restrict__ bw,
                              float* __restrict__ out,
                              float* __restrict__ lse, int n, int h_grid,
                              int w_grid, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE_FLOATS;
  float* Vs = Ks + TILE_FLOATS;
  float* Ps = Vs + TILE_FLOATS;

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t base = (size_t)g * n;
  const float* qg = q + base * HEAD_DIM;
  const float* kg = k + base * HEAD_DIM;
  const float* vg = v + base * HEAD_DIM;

  load_tile(Qs, qg, q0, n);

  // this thread's query rows; rows past n read row n-1's bias, never stored
  const float* bh_row[4];
  const float* bw_row[4];
  float m[4], den[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = min(q0 + ty + 16 * i, n - 1);
    bh_row[i] = bh + (base + qr) * h_grid;
    bw_row[i] = bw + (base + qr) * w_grid;
    m[i] = -1e30f;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the last tile's K, V and P are no longer read
    load_tile(Ks, kg, k0, n);
    load_tile(Vs, vg, k0, n);
    __syncthreads();

    float s[4][4] = {};
    mm_nt(Qs, Ks, ty, tx, s);

    int yk[4], xk[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      ok[j] = key < n;
      yk[j] = key / w_grid;
      xk[j] = key - yk[j] * w_grid;
      if (!ok[j]) yk[j] = xk[j] = 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l[4];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        l[j] = ok[j] ? logit(s[i][j], scale, bh_row[i], bw_row[i], yk[j],
                             xk[j])
                     : -INFINITY;
        tmax = fmaxf(tmax, l[j]);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(l[j] - m_new);  // 0 for a masked key
        psum += p;
        Ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
      }
      den[i] = den[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= corr;
    }
    __syncthreads();
    mm_nn(Ps, Vs, ty, tx, o);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= n) continue;
    float* orow = out + (base + qr) * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[tx + 16 * j] = o[i][j] / den[i];
    if (tx == 0) lse[base + qr] = m[i] + logf(den[i]);
  }
}

// ------------------------------------------------------ bfloat16, mma.sync
constexpr int MMA_WARPS = 4;  // 16 queries each
constexpr int KLD = HEAD_DIM + 8;  // bf16 row stride of the K and V^T tiles

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

__global__ void __launch_bounds__(MMA_WARPS * 32)
    flash_attn_fwd_mma_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ bh,
                              const float* __restrict__ bw,
                              bf16* __restrict__ out, float* __restrict__ lse,
                              int n, int h_grid, int w_grid, float scale) {
  __shared__ __align__(16) bf16 Ks[TILE * KLD];   // [key][dim]
  __shared__ __align__(16) bf16 Vt[HEAD_DIM * KLD];  // [dim][key]

  const int g = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane / 4;  // fragment row (and B column)
  const int c = lane % 4;  // fragment column pair
  const size_t base = (size_t)g * n;
  const int q0 = (int)blockIdx.x * TILE + warp * 16;
  const int q_row[2] = {q0 + r, q0 + r + 8};

  // Q as the A operand of 4 k-steps over the 64 dims; rows past n are 0
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h: the row half (r or r + 8)
      const bf16* row = q + (base + q_row[h]) * HEAD_DIM + kk * 16 + 2 * c;
      const bool ok = q_row[h] < n;
      qa[kk][h] = ok ? load_pair(row) : 0u;
      qa[kk][h + 2] = ok ? load_pair(row + 8) : 0u;
    }
  }
  const float* bh_row[2];
  const float* bw_row[2];
  float m[2] = {-1e30f, -1e30f}, den[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = min(q_row[h], n - 1);
    bh_row[h] = bh + (base + qr) * h_grid;
    bw_row[h] = bw + (base + qr) * w_grid;
  }
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  const bf16* kg = k + base * HEAD_DIM;
  const bf16* vg = v + base * HEAD_DIM;
  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the last tile's K and V^T are no longer read
    for (int e = threadIdx.x; e < TILE * (HEAD_DIM / 8); e += blockDim.x) {
      const int row = e / (HEAD_DIM / 8);
      const int col = (e % (HEAD_DIM / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < n) {
        kv = *reinterpret_cast<const uint4*>(kg + (size_t)(k0 + row) *
                                             HEAD_DIM + col);
        vv = *reinterpret_cast<const uint4*>(vg + (size_t)(k0 + row) *
                                             HEAD_DIM + col);
      }
      *reinterpret_cast<uint4*>(Ks + row * KLD + col) = kv;
      const bf16* vb = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * KLD + row] = vb[i];
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys, each 4 k-steps
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = Ks + (nt * 8 + r) * KLD + 2 * c;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_bf16(s[nt], qa[kk], load_pair(kr + kk * 16),
                 load_pair(kr + kk * 16 + 8));
    }

    // logits, the row maxima (over the quad of lanes that share a row)
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * c + j;
        const bool ok = key < n;
        const int yk = ok ? key / w_grid : 0;
        const int xk = ok ? key - yk * w_grid : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& l = s[nt][2 * h + j];
          l = ok ? logit(l, scale, bh_row[h], bw_row[h], yk, xk) : -INFINITY;
          tmax[h] = fmaxf(tmax[h], l);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m[i / 2]);  // 0 for a masked key
        psum[i / 2] += s[nt][i];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      den[h] = den[h] * corr[h] + psum[h];
    }
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the S accumulators of key tiles 2j, 2j+1 are the A operand
    // of k-step j, rounded to bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        const bf16* vr = Vt + (dt * 8 + r) * KLD + j * 16 + 2 * c;
        mma_bf16(o[dt], pa, load_pair(vr), load_pair(vr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (q_row[h] >= n) continue;
    bf16* orow = out + (base + q_row[h]) * HEAD_DIM + 2 * c;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(o[dt][2 * h] / den[h], o[dt][2 * h + 1] / den[h]);
    if (c == 0) lse[base + q_row[h]] = m[h] + logf(den[h]);
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bh, const void* bw, void* out, void* lse,
                       int g, int n, int h_grid, int w_grid, float scale,
                       cudaStream_t stream) {
  const int smem = 4 * TILE_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, g);
  flash_attn_fwd_f32_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bh),
      static_cast<const float*>(bw), static_cast<float*>(out),
      static_cast<float*>(lse), n, h_grid, w_grid, scale);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* bh, const void* bw, void* out, void* lse,
                        int g, int n, int h_grid, int w_grid, float scale,
                        cudaStream_t stream) {
  const dim3 grid((n + TILE - 1) / TILE, g);
  flash_attn_fwd_mma_kernel<<<grid, MMA_WARPS * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bh),
      static_cast<const float*>(bw), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, h_grid, w_grid, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). q, k, v, out
// [g, n, 64], bh [g, n, h_grid] and bw [g, n, w_grid] float32, lse [g, n]
// float32, all contiguous on the device, n = h_grid * w_grid. Returns
// cudaGetLastError() after the launch.
int aldi_flash_attn_fwd(const void* q, const void* k, const void* v,
                        const void* bh, const void* bw, void* out, void* lse,
                        int g, int n, int h_grid, int w_grid, int dtype,
                        float scale, void* stream) {
  if (g <= 0 || n <= 0 || h_grid <= 0 || w_grid <= 0 ||
      (long long)h_grid * w_grid != n || g > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? launch_f32(q, k, v, bh, bw, out, lse, g, n, h_grid,
                              w_grid, scale, s)
                 : launch_bf16(q, k, v, bh, bw, out, lse, g, n, h_grid,
                               w_grid, scale, s);
  return (int)err;
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
