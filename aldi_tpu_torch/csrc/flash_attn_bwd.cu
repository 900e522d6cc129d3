// Attention with the decomposed relative-position bias of the ViTDet global
// blocks, backward, for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes by aldi_tpu_torch/ops/flash_attn_kernel.py.
//
// Replaces the Pallas backward of the JAX package,
// aldi_tpu/ops/pallas_flash_attn.py:262 _attn_bwd (kernel _bwd_kernel :151).
// From the forward's LSE and delta = rowsum(dO * O) (precomputed by the
// caller, as in JAX):
//   P  = exp(logits - lse),  dS = P * (dO V^T - delta),
//   dQ = dS K scale,  dK = dS^T Q scale,  dV = P^T dO,
//   dBh[q, y] = sum_x dS[q, y w_grid + x],  dBw[q, x] = sum_y dS[q, ...],
// all in float32 (the TPU kernel converts dO and V to float32 too); dq, dk,
// dv are rounded to the input dtype, dBh and dBw stay float32.
//
// Design: two kernels, no atomics, so every result is the same on every
// run.
// (i) one block per (g, tile of 64 queries) walks the key tiles: it
//     recomputes the logits (the forward's very products and order), forms
//     P and dS, accumulates dQ in registers and the bias gradients of its
//     own query rows in shared memory. dBh and dBw of a row are summed by
//     one thread, key by key in order.
// (ii) one block per (g, tile of 64 keys) walks the query tiles, recomputes
//     P^T and dS^T for its keys and accumulates dK and dV in registers.
// Every product runs on the CUDA cores in float32, as register-blocked
// 4 x 4 micro-tiles over tiles in shared memory (flash_attn_common.cuh).
//
// What bounds it on the card: operations. The function needs ~10 N^2 64
// per (g) (q.k, dO.v, dS.k, dS^T.q, P^T.dO), ~515 GFLOP per image and
// global block of ViTDet-B at 1024x2048; this design recomputes q.k and
// dO.v in both kernels (14 N^2 64). The bound in chip_smoke.py counts the
// function's 10 N^2 64 at the dense bf16 tensor-core peak.

#include "flash_attn_common.cuh"

namespace {

using namespace flash_attn;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bh,
                             const float* __restrict__ bw,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, float* __restrict__ dbh,
                             float* __restrict__ dbw, int n, int h_grid,
                             int w_grid, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE_FLOATS;
  float* Ks = dOs + TILE_FLOATS;
  float* Vs = Ks + TILE_FLOATS;
  float* dSs = Vs + TILE_FLOATS;
  // per-row bias-gradient accumulators, odd strides (no bank conflicts
  // between the rows' owner threads)
  const int lh = h_grid | 1;
  const int lw = w_grid | 1;
  float* acc_h = dSs + TILE_FLOATS;
  float* acc_w = acc_h + TILE * lh;

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t base = (size_t)g * n;

  load_tile(Qs, q + base * HEAD_DIM, q0, n);
  load_tile(dOs, dout + base * HEAD_DIM, q0, n);
  for (int e = threadIdx.x; e < TILE * (lh + lw); e += THREADS) acc_h[e] = 0.f;

  const float* bh_row[4];
  const float* bw_row[4];
  float row_lse[4], row_delta[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = min(q0 + ty + 16 * i, n - 1);
    bh_row[i] = bh + (base + qr) * h_grid;
    bw_row[i] = bw + (base + qr) * w_grid;
    row_lse[i] = lse[base + qr];
    row_delta[i] = delta[base + qr];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the last tile's K, V and dS are no longer read
    load_tile(Ks, k + base * HEAD_DIM, k0, n);
    load_tile(Vs, v + base * HEAD_DIM, k0, n);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    mm_nt(Qs, Ks, ty, tx, s);
    mm_nt(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool ok = key < n;
      const int yk = ok ? key / w_grid : 0;
      const int xk = ok ? key - yk * w_grid : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            ok ? expf(logit(s[i][j], scale, bh_row[i], bw_row[i], yk, xk) -
                      row_lse[i])
               : 0.f;
        dSs[(ty + 16 * i) * LD + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    mm_nn(dSs, Ks, ty, tx, acc);

    // the bias gradients: thread r sums dS of row r into dBh, thread
    // 64 + r into dBw, key by key in order
    const int kn = min(TILE, n - k0);
    if (threadIdx.x < TILE) {
      const int r = threadIdx.x;
      int y = k0 / w_grid;
      int x = k0 - y * w_grid;
      float run = 0.f;
      for (int c = 0; c < kn; ++c) {
        run += dSs[r * LD + c];
        if (++x == w_grid || c == kn - 1) {  // end of a grid row or tile
          acc_h[r * lh + y] += run;
          run = 0.f;
          if (x == w_grid) {
            x = 0;
            ++y;
          }
        }
      }
    } else if (threadIdx.x < 2 * TILE) {
      const int r = threadIdx.x - TILE;
      int x = k0 % w_grid;
      for (int c = 0; c < kn; ++c) {
        acc_w[r * lw + x] += dSs[r * LD + c];
        if (++x == w_grid) x = 0;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= n) continue;
    T* row = dq + (base + qr) * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      row[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
  for (int e = threadIdx.x; e < TILE * h_grid; e += THREADS) {
    const int r = e / h_grid;
    if (q0 + r < n)
      dbh[(base + q0 + r) * h_grid + e % h_grid] = acc_h[r * lh + e % h_grid];
  }
  for (int e = threadIdx.x; e < TILE * w_grid; e += THREADS) {
    const int r = e / w_grid;
    if (q0 + r < n)
      dbw[(base + q0 + r) * w_grid + e % w_grid] = acc_w[r * lw + e % w_grid];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attn_bwd_dkdv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ bh,
                               const float* __restrict__ bw,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int n,
                               int h_grid, int w_grid, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE_FLOATS;
  float* Qs = Vs + TILE_FLOATS;
  float* dOs = Qs + TILE_FLOATS;
  float* Pt = dOs + TILE_FLOATS;
  float* dSt = Pt + TILE_FLOATS;

  const int g = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t base = (size_t)g * n;

  load_tile(Ks, k + base * HEAD_DIM, k0, n);
  load_tile(Vs, v + base * HEAD_DIM, k0, n);

  // this thread's key rows ty + 16 i
  bool ok_k[4];
  int yk[4], xk[4];
  float dk_acc[4][4], dv_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    ok_k[i] = key < n;
    yk[i] = ok_k[i] ? key / w_grid : 0;
    xk[i] = ok_k[i] ? key - yk[i] * w_grid : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += TILE) {
    __syncthreads();  // the last tile's Q, dO, P^T and dS^T are no longer read
    load_tile(Qs, q + base * HEAD_DIM, q0, n);
    load_tile(dOs, dout + base * HEAD_DIM, q0, n);
    __syncthreads();

    float st[4][4] = {}, dpt[4][4] = {};
    mm_nt(Ks, Qs, ty, tx, st);   // [key][query]
    mm_nt(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = q0 + tx + 16 * j;
      const bool ok_q = qr < n;
      const int qc = min(qr, n - 1);
      const float* bh_row = bh + (base + qc) * h_grid;
      const float* bw_row = bw + (base + qc) * w_grid;
      const float l_q = lse[base + qc];
      const float d_q = delta[base + qc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            ok_q && ok_k[i]
                ? expf(logit(st[i][j], scale, bh_row, bw_row, yk[i], xk[i]) -
                       l_q)
                : 0.f;
        Pt[(ty + 16 * i) * LD + tx + 16 * j] = p;
        dSt[(ty + 16 * i) * LD + tx + 16 * j] = p * (dpt[i][j] - d_q);
      }
    }
    __syncthreads();
    mm_nn(Pt, dOs, ty, tx, dv_acc);
    mm_nn(dSt, Qs, ty, tx, dk_acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!ok_k[i]) continue;
    const size_t row = (base + k0 + ty + 16 * i) * HEAD_DIM;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[row + tx + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[row + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

int dq_smem_bytes(int h_grid, int w_grid) {
  return (5 * TILE_FLOATS + TILE * ((h_grid | 1) + (w_grid | 1))) *
         (int)sizeof(float);
}

constexpr int DKDV_SMEM_BYTES = 6 * TILE_FLOATS * (int)sizeof(float);

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bh, const void* bw, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, void* dbh, void* dbw, int g, int n, int h_grid,
                   int w_grid, float scale, cudaStream_t stream) {
  const int smem_dq = dq_smem_bytes(h_grid, w_grid);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKDV_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, g);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* bhf = static_cast<const float*>(bh);
  const float* bwf = static_cast<const float*>(bw);
  const float* lsef = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  flash_attn_bwd_dq_kernel<T><<<grid, THREADS, smem_dq, stream>>>(
      qt, kt, vt, bhf, bwf, dot, lsef, deltaf, static_cast<T*>(dq),
      static_cast<float*>(dbh), static_cast<float*>(dbw), n, h_grid, w_grid,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dkdv_kernel<T><<<grid, THREADS, DKDV_SMEM_BYTES, stream>>>(
      qt, kt, vt, bhf, bwf, dot, lsef, deltaf, static_cast<T*>(dk),
      static_cast<T*>(dv), n, h_grid, w_grid, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory (bytes) the dq kernel needs for this grid; the wrapper
// raises when it exceeds the card's 227 KB per block.
int aldi_flash_attn_bwd_smem(int h_grid, int w_grid) {
  return dq_smem_bytes(h_grid, w_grid);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv). q, k, v,
// dout, dq, dk, dv [g, n, 64]; bh, dbh [g, n, h_grid]; bw, dbw
// [g, n, w_grid]; lse and delta [g, n]; all float32 unless named above,
// contiguous on the device, n = h_grid * w_grid. Launches both kernels on
// the stream and returns the first CUDA error.
int aldi_flash_attn_bwd(const void* q, const void* k, const void* v,
                        const void* bh, const void* bw, const void* dout,
                        const void* lse, const void* delta, void* dq,
                        void* dk, void* dv, void* dbh, void* dbw, int g,
                        int n, int h_grid, int w_grid, int dtype, float scale,
                        void* stream) {
  if (g <= 0 || n <= 0 || h_grid <= 0 || w_grid <= 0 ||
      (long long)h_grid * w_grid != n || g > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch<float>(q, k, v, bh, bw, dout, lse, delta, dq, dk, dv, dbh,
                          dbw, g, n, h_grid, w_grid, scale, s)
          : launch<__nv_bfloat16>(q, k, v, bh, bw, dout, lse, delta, dq, dk,
                                  dv, dbh, dbw, g, n, h_grid, w_grid, scale,
                                  s);
  return (int)err;
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
