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
//   dBh[q, y] = sum_x dS[q, y w_grid + x],  dBw[q, x] = sum_y dS[q, ...].
// The TPU kernel keeps P and dS in float32 and converts dO and V to float32;
// dq, dk, dv are rounded to the input dtype, dBh and dBw stay float32.
//
// What bounds it on the card: operations. The function needs 10 N^2 64 per
// head (q.k, dO.v, dS.k, dS^T.q, P^T.dO), ~515 GFLOP per image and global
// block of ViTDet-B at 1024x2048, 0.52 ms at the dense bf16 tensor-core
// peak. On the CUDA cores (67 TFLOP/s in float32) no design can come near
// that, so the bfloat16 path runs every product on the tensor cores:
// - Two kernels, no atomics, so every result is the same on every run.
//   (i) one block of 4 warps per (head, tile of 64 queries) walks the key
//   tiles and owns dQ and its rows' dBh/dBw; (ii) one block per (head, tile
//   of 64 keys) walks the query tiles and owns dK and dV. Each recomputes
//   q.k and dO.v: 14 N^2 64 products, issued as 20 N^2 64 tensor-core
//   operations with the split below.
// - S = Q K^T and dP = dO V^T by mma.sync.m16n8k16 (bf16 in, f32
//   accumulate): the inputs are exact bf16, so these are the float32
//   version's products summed in another order. The row operand (Q and dO
//   in (i), K and V in (ii), keys as rows so that P^T and dS^T come out in
//   A-operand layout) stays in registers; the other goes through shared
//   memory.
// - dQ = dS K, dK = dS^T Q, dV = P^T dO take P and dS from the float32
//   accumulators in registers, split as hi = bf16(x), lo = bf16(x - hi): two
//   MMAs against the exact bf16 operand, ~2^-16 relative error, where one
//   bf16 rounding of dS (2^-9) would break the stated tolerance.
// - The streamed tiles (K, V in (i); Q, dO and the gathered bias, lse and
//   delta in (ii)) come in by cp.async into a double buffer, so the next
//   tile's copy overlaps this tile's products; fragments are read with
//   ldmatrix (.trans for the [k][n] operands).
// - The issue rate of each warp's instructions, not the tensor cores,
//   bounds the kernels: a 64-column tile is processed in two halves of 32,
//   which keeps the live accumulators at 32 floats and each kernel at 168
//   registers, 3 blocks (12 warps) per SM.
// - dBh and dBw come from dS in registers. For even grids at least 64 wide
//   a 64-key tile spans at most two grid rows, holds each column x once
//   and its column pairs never straddle a row: each thread adds its dS
//   pairs into the block's dBw rows in shared memory (one owner per entry
//   in a tile), and its per-row partial sums for dBh are reduced over the
//   quad of lanes that shares a row into a running sum, stored when its
//   grid row is complete. Other grids stage the warp's dS in shared
//   memory, and the lanes sum each (row, x) and (row, y) of the tile in key
//   order. key -> (y, x) comes from the tile's first key, not a division
//   per element.
// The float32 path (the tiny float32 reference detectors) keeps the
// CUDA-core kernels: float32 tiles in shared memory and 4 x 4 register
// micro-tiles (flash_attn_common.cuh), dBh/dBw summed key by key.

#include "flash_attn_common.cuh"
#include "flash_attn_mma.cuh"

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

// ------------------------------------------------- bfloat16, tensor cores
constexpr int MMA_WARPS = 4;  // 16 rows of the tile each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int HALF = TILE / 2;  // columns of S per step of the inner loop
constexpr int SLD = TILE + 4;   // float row stride of staged dS and bias

// the dq kernel's fast bias-gradient path: grids at least a tile wide with
// an even width (a 64-key tile spans at most two grid rows, holds each
// column x once, and its column pairs never straddle a grid row)
__host__ __device__ inline bool pairs_fit(int w_grid) {
  return w_grid >= TILE && w_grid % 2 == 0;
}

// row stride of the dBw accumulators: at least w_grid, 8 mod 32 floats, so
// the float2 adds of a half-warp's 4 rows x 4 column pairs miss each other
__host__ __device__ inline int acc_w_ld(int w_grid) {
  return (w_grid + 23) / 32 * 32 + 8;
}

// shared memory of the dq kernel: two stages of K and V and the block's dBw
// accumulators [64][acc_w_ld]; off the fast path also dBh [64][h_grid | 1]
// and the warps' dS tiles [16][SLD]
__host__ __device__ inline int dq_mma_smem_bytes(int h_grid, int w_grid) {
  return 4 * BTILE * (int)sizeof(bf16) +
         (TILE * acc_w_ld(w_grid) +
          (pairs_fit(w_grid) ? 0 : TILE * ((h_grid | 1) + SLD))) *
             (int)sizeof(float);
}

// the most grid rows that the keys of one tile can span
__host__ __device__ inline int bias_rows(int h_grid, int w_grid) {
  const int rows = (TILE - 1) / w_grid + 2;
  return rows < h_grid ? rows : h_grid;
}

// one stage of the dk/dv kernel: the Q and dO tiles, then float32 Bw at
// the block's 64 keys [64 queries][SLD], Bh at the block's grid rows
// [64][nyb], lse and delta [64]; a multiple of 16 bytes
__host__ __device__ inline int dkdv_stage_bytes(int nyb) {
  return 2 * BTILE * (int)sizeof(bf16) +
         (TILE * SLD + TILE * nyb + 2 * TILE) * (int)sizeof(float);
}

__host__ __device__ inline int dkdv_smem_bytes(int nyb) {
  return 2 * dkdv_stage_bytes(nyb);
}

// (i) dQ and the bias gradients of a tile of 64 queries
__global__ void __launch_bounds__(MMA_THREADS, 3)
    flash_attn_bwd_dq_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const float* __restrict__ bh,
        const float* __restrict__ bw, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dq, float* __restrict__ dbh,
        float* __restrict__ dbw, int n, int h_grid, int w_grid,
        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv = reinterpret_cast<bf16*>(smem_raw);  // stage s: K, then V
  const bool paired = pairs_fit(w_grid);
  const int lw = acc_w_ld(w_grid);
  const int lh = h_grid | 1;
  float* acc_w = reinterpret_cast<float*>(kv + 4 * BTILE);
  float* acc_h = acc_w + TILE * lw;  // off the fast path
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r = lane / 4;
  const int c = lane % 4;
  float* ws = acc_h + TILE * lh + warp * 16 * SLD;  // off the fast path

  const int g = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)g * n;
  const bf16* kg = k + base * HEAD_DIM;
  const bf16* vg = v + base * HEAD_DIM;

  load_tile_async(kv, kg, 0, n, tid, MMA_THREADS);
  load_tile_async(kv + BTILE, vg, 0, n, tid, MMA_THREADS);
  cp_async_commit();
  for (int e = tid; e < TILE * (paired ? lw : lw + lh); e += MMA_THREADS)
    acc_w[e] = 0.f;

  // this thread's rows: r and r + 8 of the warp's 16
  const int lrow[2] = {warp * 16 + r, warp * 16 + r + 8};
  const int qrow[2] = {q0 + lrow[0], q0 + lrow[1]};
  uint32_t qa[4][4], oa[4][4];
  load_a_rows(qa, q + base * HEAD_DIM, qrow, n, c);
  load_a_rows(oa, dout + base * HEAD_DIM, qrow, n, c);
  const float* bh_row[2];
  const float* bw_row[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qc = min(qrow[h], n - 1);  // rows past n are never stored
    bh_row[h] = bh + (base + qc) * h_grid;
    bw_row[h] = bw + (base + qc) * w_grid;
    lse2[h] = lse[base + qc] * LOG2E;
    dlt[h] = delta[base + qc];
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  // fast path: each row's running dBh sum over the grid row of the next key
  float run[2] = {0.f, 0.f};

  const int ntiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with t - 1
    if (t + 1 < ntiles) {
      bf16* next = kv + ((t + 1) & 1) * 2 * BTILE;
      load_tile_async(next, kg, k0 + TILE, n, tid, MMA_THREADS);
      load_tile_async(next + BTILE, vg, k0 + TILE, n, tid, MMA_THREADS);
      cp_async_commit();
    }
    const bf16* Ks = kv + (t & 1) * 2 * BTILE;
    const bf16* Vs = Ks + BTILE;

    // key -> (y, x) from the tile's first key. Fast path: keys at or past
    // (y0 + 1) w_grid lie in grid row y0 + 1; each thread adds its dS into
    // dBw and into two dBh partial sums per row
    const int y0 = k0 / w_grid;
    const int x0 = k0 - y0 * w_grid;
    const bool straddle = (y0 + 1) * w_grid < min(n, k0 + TILE);
    float sh[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float bhy[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (paired) {
      const int y1 = min(y0 + 1, h_grid - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bhy[h][0] = __ldg(bh_row[h] + y0);
        bhy[h][1] = __ldg(bh_row[h] + y1);
      }
    }

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * HALF;  // the half's first key column
      // S = Q K^T and dP = dO V^T: 4 tiles of 8 keys, 4 k-steps each
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          uint32_t b[4];
          ldb_nk(b, Ks, c0 + nt * 8, kp * 32, lane);
          mma_bf16(s[nt], qa[2 * kp], b[0], b[1]);
          mma_bf16(s[nt], qa[2 * kp + 1], b[2], b[3]);
          ldb_nk(b, Vs, c0 + nt * 8, kp * 32, lane);
          mma_bf16(dp[nt], oa[2 * kp], b[0], b[1]);
          mma_bf16(dp[nt], oa[2 * kp + 1], b[2], b[3]);
        }
      }

      // P and dS (into dp)
      if (paired) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = c0 + nt * 8 + 2 * c;
          const bool ok = k0 + col < n;  // n is even: both keys or neither
          int x = x0 + col;
          const bool next_row = straddle && x >= w_grid;
          if (next_row) x -= w_grid;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2 ds = make_float2(0.f, 0.f);
            if (ok) {
              const float b = next_row ? bhy[h][1] : bhy[h][0];
              const float2 bwx =
                  __ldg(reinterpret_cast<const float2*>(bw_row[h] + x));
              const float l0 = (s[nt][2 * h] * scale + b) + bwx.x;
              const float l1 = (s[nt][2 * h + 1] * scale + b) + bwx.y;
              ds.x = ex2(fmaf(l0, LOG2E, -lse2[h])) *
                     (dp[nt][2 * h] - dlt[h]);
              ds.y = ex2(fmaf(l1, LOG2E, -lse2[h])) *
                     (dp[nt][2 * h + 1] - dlt[h]);
              float2* aw =
                  reinterpret_cast<float2*>(acc_w + lrow[h] * lw + x);
              float2 w = *aw;
              w.x += ds.x;
              w.y += ds.y;
              *aw = w;
              if (straddle) {
                sh[h][0] += next_row ? 0.f : ds.x + ds.y;
                sh[h][1] += next_row ? ds.x + ds.y : 0.f;
              } else {
                sh[h][0] += ds.x + ds.y;
              }
            }
            dp[nt][2 * h] = ds.x;
            dp[nt][2 * h + 1] = ds.y;
          }
        }
      } else {
        // a running grid cell per column; dS also goes to the warp's tile
        int yr = y0, xr = x0 + c0 + 2 * c;
        while (xr >= w_grid) {
          xr -= w_grid;
          ++yr;
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = c0 + nt * 8 + 2 * c + j;
            const bool ok = k0 + col < n;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float ds = 0.f;
              if (ok) {
                const float l = (s[nt][2 * h + j] * scale +
                                 __ldg(bh_row[h] + yr)) +
                                __ldg(bw_row[h] + xr);
                ds = ex2(fmaf(l, LOG2E, -lse2[h])) *
                     (dp[nt][2 * h + j] - dlt[h]);
              }
              dp[nt][2 * h + j] = ds;
              ws[(r + 8 * h) * SLD + col] = ds;
            }
            xr += j == 0 ? 1 : 7;
            while (xr >= w_grid) {
              xr -= w_grid;
              ++yr;
            }
          }
        }
      }

      // dQ += dS K over the half's 32 keys, dS split into hi + lo bf16: the
      // accumulators of key tiles 2j and 2j + 1 are the A operand of k-step j
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t ah[4], al[4];
        split_bf16(dp[2 * j][0], dp[2 * j][1], ah[0], al[0]);
        split_bf16(dp[2 * j][2], dp[2 * j][3], ah[1], al[1]);
        split_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1], ah[2], al[2]);
        split_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldb_kn(b, Ks, c0 + j * 16, np * 16, lane);
          mma_bf16(acc[2 * np], ah, b[0], b[1]);
          mma_bf16(acc[2 * np], al, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
          mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
        }
      }
    }

    if (paired) {
      // dBh: a row's partial sums over the quad of lanes that hold it. The
      // running sum takes grid row y0's part; when the tile reaches the end
      // of grid row y0, that row is complete and is stored
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          sh[h][i] += __shfl_xor_sync(0xffffffffu, sh[h][i], 1);
          sh[h][i] += __shfl_xor_sync(0xffffffffu, sh[h][i], 2);
        }
        run[h] += sh[h][0];
      }
      if ((y0 + 1) * w_grid <= min(n, k0 + TILE)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (c == 0 && qrow[h] < n)
            dbh[(base + qrow[h]) * h_grid + y0] = run[h];
          run[h] = sh[h][1];
        }
      }
    } else {
      // each lane sums whole (row, x) and (row, y) entries of the warp's
      // dS tile in key order
      __syncwarp();
      const int kn = min(TILE, n - k0);
      const int nx = min(w_grid, kn);
      for (int i = lane; i < 16 * nx; i += 32) {
        const int row = i / nx;
        const int jx = i - row * nx;
        float sum = 0.f;
        for (int cc = jx; cc < kn; cc += w_grid) sum += ws[row * SLD + cc];
        const int x = x0 + jx < w_grid ? x0 + jx : x0 + jx - w_grid;
        acc_w[(warp * 16 + row) * lw + x] += sum;
      }
      const int ny = (k0 + kn - 1) / w_grid - y0 + 1;
      for (int i = lane; i < 16 * ny; i += 32) {
        const int row = i / ny;
        const int y = y0 + i - row * ny;
        const int lo = max(k0, y * w_grid) - k0;
        const int hi = min(k0 + kn, (y + 1) * w_grid) - k0;
        float sum = 0.f;
        for (int cc = lo; cc < hi; ++cc) sum += ws[row * SLD + cc];
        acc_h[(warp * 16 + row) * lh + y] += sum;
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= n) continue;
    bf16* row = dq + (base + qrow[h]) * HEAD_DIM + 2 * c;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8) =
          pack_bf16(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
  }
  __syncthreads();
  for (int e = tid; e < TILE * w_grid; e += MMA_THREADS) {
    const int rr = e / w_grid;
    if (q0 + rr < n)
      dbw[(base + q0 + rr) * w_grid + e - rr * w_grid] =
          acc_w[rr * lw + e - rr * w_grid];
  }
  if (!paired) {
    for (int e = tid; e < TILE * h_grid; e += MMA_THREADS) {
      const int rr = e / h_grid;
      if (q0 + rr < n)
        dbh[(base + q0 + rr) * h_grid + e - rr * h_grid] =
            acc_h[rr * lh + e - rr * h_grid];
    }
  }
}

struct DkdvStage {
  bf16* q;
  bf16* dout;
  float* bw;  // [64 queries][SLD]: Bw at the block's keys
  float* bh;  // [64 queries][nyb]: Bh at the block's grid rows
  float* lse;
  float* delta;
};

__device__ __forceinline__ DkdvStage dkdv_stage(unsigned char* smem, int s,
                                                int nyb) {
  DkdvStage st;
  st.q = reinterpret_cast<bf16*>(smem + s * dkdv_stage_bytes(nyb));
  st.dout = st.q + BTILE;
  st.bw = reinterpret_cast<float*>(st.dout + BTILE);
  st.bh = st.bw + TILE * SLD;
  st.lse = st.bh + TILE * nyb;
  st.delta = st.lse + TILE;
  return st;
}

// the query tile from q0 into a stage, by cp.async: Q and dO rows, lse and
// delta, and the bias of those queries at the block's keys (from k0, grid
// rows from yk0; x_key: the column of key k0 + tid % 64)
__device__ __forceinline__ void load_dkdv_stage(
    const DkdvStage& st, const bf16* __restrict__ qg,
    const bf16* __restrict__ dog, const float* __restrict__ bh,
    const float* __restrict__ bw, const float* __restrict__ lse,
    const float* __restrict__ delta, size_t base, int q0, int k0, int yk0,
    int x_key, int n, int h_grid, int w_grid, int nyb, int tid) {
  load_tile_async(st.q, qg, q0, n, tid, MMA_THREADS);
  load_tile_async(st.dout, dog, q0, n, tid, MMA_THREADS);
  {
    const int i = tid % TILE;
    const bool ok = q0 + i < n;
    const size_t row = base + (ok ? q0 + i : 0);
    if (tid < TILE)
      cp_async4(st.lse + i, lse + row, ok);
    else
      cp_async4(st.delta + i, delta + row, ok);
  }
  if (w_grid % TILE == 0) {  // the block's keys: 64 whole columns of a row
    const int xf = k0 - yk0 * w_grid;
    for (int e = tid; e < TILE * 16; e += MMA_THREADS) {
      const int qi = e >> 4;
      const int col = (e & 15) * 4;
      const bool ok = q0 + qi < n;
      cp_async16(st.bw + qi * SLD + col,
                 bw + (base + (ok ? q0 + qi : 0)) * w_grid + xf + col, ok);
    }
  } else {  // thread tid gathers key tid % 64 for every other query row
    const int kj = tid % TILE;
    for (int qi = tid / TILE; qi < TILE; qi += MMA_THREADS / TILE) {
      const bool ok = k0 + kj < n && q0 + qi < n;
      cp_async4(st.bw + qi * SLD + kj,
                bw + (base + (ok ? q0 + qi : 0)) * w_grid + (ok ? x_key : 0),
                ok);
    }
  }
  for (int e = tid; e < TILE * nyb; e += MMA_THREADS) {
    const int qi = e / nyb;
    const int i = e - qi * nyb;
    const bool ok = q0 + qi < n && yk0 + i < h_grid;
    cp_async4(st.bh + e,
              bh + (base + (ok ? q0 + qi : 0)) * h_grid + (ok ? yk0 + i : 0),
              ok);
  }
  cp_async_commit();
}

// (ii) dK and dV of a tile of 64 keys
__global__ void __launch_bounds__(MMA_THREADS, 3)
    flash_attn_bwd_dkdv_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const float* __restrict__ bh,
        const float* __restrict__ bw, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int h_grid,
        int w_grid, int nyb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r = lane / 4;
  const int c = lane % 4;
  const int g = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  const size_t base = (size_t)g * n;
  const bf16* qg = q + base * HEAD_DIM;
  const bf16* dog = dout + base * HEAD_DIM;
  const int yk0 = k0 / w_grid;  // grid row of the block's first key
  const int kj = tid % TILE;
  const int x_key = k0 + kj < n ? (k0 + kj) % w_grid : 0;

  load_dkdv_stage(dkdv_stage(smem_raw, 0, nyb), qg, dog, bh, bw, lse, delta,
                  base, 0, k0, yk0, x_key, n, h_grid, w_grid, nyb, tid);

  // this thread's keys (rows of S^T): r and r + 8 of the warp's 16
  const int kcol[2] = {warp * 16 + r, warp * 16 + r + 8};
  const int krow[2] = {k0 + kcol[0], k0 + kcol[1]};
  bool kok[2];
  int seg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kok[h] = krow[h] < n;
    seg[h] = kok[h] ? krow[h] / w_grid - yk0 : 0;
  }
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k + base * HEAD_DIM, krow, n, c);
  load_a_rows(va, v + base * HEAD_DIM, krow, n, c);
  float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;

  const int ntiles = (n + TILE - 1) / TILE;
  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with t - 1
    if (t + 1 < ntiles)
      load_dkdv_stage(dkdv_stage(smem_raw, (t + 1) & 1, nyb), qg, dog, bh,
                      bw, lse, delta, base, q0 + TILE, k0, yk0, x_key, n,
                      h_grid, w_grid, nyb, tid);
    const DkdvStage st = dkdv_stage(smem_raw, t & 1, nyb);

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * HALF;  // the half's first query column
      // S^T = K Q^T and dP^T = V dO^T: 4 tiles of 8 queries, 4 k-steps each
      float pt[4][4], dst[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pt[nt][i] = dst[nt][i] = 0.f;
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          uint32_t b[4];
          ldb_nk(b, st.q, c0 + nt * 8, kp * 32, lane);
          mma_bf16(pt[nt], ka[2 * kp], b[0], b[1]);
          mma_bf16(pt[nt], ka[2 * kp + 1], b[2], b[3]);
          ldb_nk(b, st.dout, c0 + nt * 8, kp * 32, lane);
          mma_bf16(dst[nt], va[2 * kp], b[0], b[1]);
          mma_bf16(dst[nt], va[2 * kp + 1], b[2], b[3]);
        }
      }
      // P^T (into pt) and dS^T (into dst); masked pairs are 0
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = c0 + nt * 8 + 2 * c + j;
          const bool qok = q0 + col < n;
          const float l2 = st.lse[col] * LOG2E;
          const float d = st.delta[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p = 0.f;
            if (qok && kok[h]) {
              const float l = (pt[nt][2 * h + j] * scale +
                               st.bh[col * nyb + seg[h]]) +
                              st.bw[col * SLD + kcol[h]];
              p = ex2(fmaf(l, LOG2E, -l2));
            }
            pt[nt][2 * h + j] = p;
            dst[nt][2 * h + j] = p * (dst[nt][2 * h + j] - d);
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q over the half's 32 queries, P^T and
      // dS^T split into hi + lo bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t hi[4], lo[4];
        split_bf16(pt[2 * j][0], pt[2 * j][1], hi[0], lo[0]);
        split_bf16(pt[2 * j][2], pt[2 * j][3], hi[1], lo[1]);
        split_bf16(pt[2 * j + 1][0], pt[2 * j + 1][1], hi[2], lo[2]);
        split_bf16(pt[2 * j + 1][2], pt[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldb_kn(b, st.dout, c0 + j * 16, np * 16, lane);
          mma_bf16(dv_acc[2 * np], hi, b[0], b[1]);
          mma_bf16(dv_acc[2 * np], lo, b[0], b[1]);
          mma_bf16(dv_acc[2 * np + 1], hi, b[2], b[3]);
          mma_bf16(dv_acc[2 * np + 1], lo, b[2], b[3]);
        }
        split_bf16(dst[2 * j][0], dst[2 * j][1], hi[0], lo[0]);
        split_bf16(dst[2 * j][2], dst[2 * j][3], hi[1], lo[1]);
        split_bf16(dst[2 * j + 1][0], dst[2 * j + 1][1], hi[2], lo[2]);
        split_bf16(dst[2 * j + 1][2], dst[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldb_kn(b, st.q, c0 + j * 16, np * 16, lane);
          mma_bf16(dk_acc[2 * np], hi, b[0], b[1]);
          mma_bf16(dk_acc[2 * np], lo, b[0], b[1]);
          mma_bf16(dk_acc[2 * np + 1], hi, b[2], b[3]);
          mma_bf16(dk_acc[2 * np + 1], lo, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!kok[h]) continue;
    const size_t row = (base + krow[h]) * HEAD_DIM + 2 * c;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<uint32_t*>(dk + row + nt * 8) =
          pack_bf16(dk_acc[nt][2 * h] * scale, dk_acc[nt][2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + nt * 8) =
          pack_bf16(dv_acc[nt][2 * h], dv_acc[nt][2 * h + 1]);
    }
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* bh, const void* bw, const void* dout,
                        const void* lse, const void* delta, void* dq,
                        void* dk, void* dv, void* dbh, void* dbw, int g,
                        int n, int h_grid, int w_grid, float scale,
                        cudaStream_t stream) {
  const int smem_dq = dq_mma_smem_bytes(h_grid, w_grid);
  const int nyb = bias_rows(h_grid, w_grid);
  const int smem_kv = dkdv_smem_bytes(nyb);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_bwd_dkdv_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, g);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* bhf = static_cast<const float*>(bh);
  const float* bwf = static_cast<const float*>(bw);
  const float* lsef = static_cast<const float*>(lse);
  const float* deltaf = static_cast<const float*>(delta);
  flash_attn_bwd_dq_mma_kernel<<<grid, MMA_THREADS, smem_dq, stream>>>(
      qt, kt, vt, bhf, bwf, dot, lsef, deltaf, static_cast<bf16*>(dq),
      static_cast<float*>(dbh), static_cast<float*>(dbw), n, h_grid, w_grid,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dkdv_mma_kernel<<<grid, MMA_THREADS, smem_kv, stream>>>(
      qt, kt, vt, bhf, bwf, dot, lsef, deltaf, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, h_grid, w_grid, nyb, scale);
  return cudaGetLastError();
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

// The shared memory (bytes) the larger of the two kernels needs per block
// for this grid and dtype (0 = float32, 1 = bfloat16); the wrapper raises
// when it exceeds the card's 227 KB per block.
int aldi_flash_attn_bwd_smem(int h_grid, int w_grid, int dtype) {
  if (h_grid <= 0 || w_grid <= 0) return 0;
  if (dtype == 0) {
    const int dq = dq_smem_bytes(h_grid, w_grid);
    return dq > DKDV_SMEM_BYTES ? dq : DKDV_SMEM_BYTES;
  }
  const int dq = dq_mma_smem_bytes(h_grid, w_grid);
  const int dkdv = dkdv_smem_bytes(bias_rows(h_grid, w_grid));
  return dq > dkdv ? dq : dkdv;
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
          : launch_bf16(q, k, v, bh, bw, dout, lse, delta, dq, dk, dv, dbh,
                        dbw, g, n, h_grid, w_grid, scale, s);
  return (int)err;
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
