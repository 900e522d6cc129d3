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
// k % w_grid). The bias of a logit is read from the query's Bh and Bw rows:
// the one-hot expander matmuls of the TPU kernel exist only because Mosaic
// rejects a lane broadcast. Rounding follows the TPU kernel: q.k is a
// float32 sum of exact products, the probabilities are rounded to the input
// dtype before P.V while the denominator sums them unrounded, out is
// rounded to the input dtype once. Keys at or past N get probability 0,
// queries past N are computed on zero rows and not stored.
//
// What bounds it on the card: operations, 4 N^2 64 per head (q.k and P.v),
// ~206 GFLOP per image and global block of ViTDet-B at 1024x2048 against
// ~125 MB of inputs and outputs: 0.21 ms at the dense bf16 tensor-core
// peak. Besides the products, every logit takes a bias of two terms, a
// maximum, an exponential and a sum, so the design keeps the tensor cores
// fed while the CUDA cores do that work (FlashAttention-3's layout):
// - bfloat16 (the detector's dtype): a block of 128 queries and three
//   warpgroups. The producer warpgroup gives up its registers (setmaxnreg)
//   and one of its threads brings Q once and the K and V tiles of 128 keys
//   through a ring of two stages by TMA (128-byte swizzle, zero fill past
//   N, mbarriers for full and empty stages). Each of the two consumer
//   warpgroups owns 64 queries: S = Q K^T by wgmma m64n128k16 with both
//   operands in shared memory, then the softmax in registers, then
//   O += P V by wgmma m64n64k16 with P (rounded to bf16) from registers
//   and V read transposed by the descriptor. The block's Bw and Bh rows are
//   staged in shared memory once; key -> (y, x) comes from running
//   counters, and where a tile spans at most two grid rows (the ViT's
//   grids) Bh is read once per row and tile and Bw as float2. The
//   exponentials are exp2 of log2(e)-scaled differences from the running
//   maximum. Within a warpgroup, the softmax of one tile runs while the
//   tensor cores compute the previous tile's P.V and the next tile's S.
// - float32 (the tiny reference detectors): 256 threads, Q, K, V and P as
//   float32 tiles in shared memory, both products on the CUDA cores as
//   register-blocked 4 x 4 micro-tiles (flash_attn_common.cuh).

#include <cuda.h>

#include <cstdint>

#include "flash_attn_common.cuh"
#include "flash_attn_mma.cuh"

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

// ------------------------------------------- bfloat16, wgmma with TMA
// A block owns 128 queries: warpgroups 0 and 1 (the consumers) each own 64
// of them, warpgroup 2 (the producer) issues the TMA loads.
constexpr int BM = 128;             // queries per block
constexpr int BN = 128;             // keys per tile
constexpr int STAGES = 2;           // K/V ring
constexpr int CONSUMERS = 2 * 128;  // threads of the two consumer warpgroups
constexpr int FWD_THREADS = CONSUMERS + 128;
constexpr int ROW_BYTES = HEAD_DIM * 2;      // one bf16 row: 128 bytes
constexpr int Q_BYTES = BM * ROW_BYTES;      // 16 KB
constexpr int KV_BYTES = BN * ROW_BYTES;     // 16 KB per K or V tile

// float row stride of the staged bias rows: at least `width`, 8 mod 32, so
// the float2 reads of a half-warp's 4 rows x 4 column pairs miss each other
__host__ __device__ inline int bias_ld(int width) {
  return (width + 23) / 32 * 32 + 8;
}

// shared memory: 1 KB of alignment slack, Q, the K and V stages (each 1 KB
// aligned for the 128-byte swizzle), the block's Bw and Bh rows, barriers
__host__ __device__ inline int fwd_smem_bytes(int h_grid, int w_grid) {
  return 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
         BM * (bias_ld(w_grid) + bias_ld(h_grid)) * (int)sizeof(float) +
         (1 + 4 * STAGES) * 8;
}

// the fast bias path: every key tile spans at most two grid rows and its
// column pairs never straddle one (w_grid even, 128 - gcd(w_grid, 128) <=
// w_grid: 64, 96, 128 and any even width >= 128 qualify)
inline bool fwd_pairs_fit(int w_grid) {
  int a = w_grid, b = BN;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return w_grid % 2 == 0 && BN - a <= w_grid;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// rows [row, row + box) of head g of a [G, N, 64] bf16 tensor into shared
// memory, 128-byte swizzled; rows past N arrive as zeros
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int g) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(g)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory
// (rows of 128 bytes, 8-row groups 1024 bytes apart; LBO is read only for
// MN-major operands wider than 64 elements)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin a register that a wgmma in flight reads or writes: the compiler may
// neither move its accesses across the fence nor reuse it before
__device__ __forceinline__ void fence_regs(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_u32(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// D (64 x 128, f32) (+)= A (64 x 16, smem, K-major) B (16 x 128, smem,
// K-major)
__device__ __forceinline__ void wgmma_m64n128_ss(float d[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n64_rs_tb(float d[32], const uint32_t a[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// S = Q K^T of key tile t (64 x 128 per warpgroup), 4 k-steps of 16 dims,
// once the tile's K has landed; issued and committed, not waited for
__device__ __forceinline__ void issue_s(float (&sacc)[64], uint64_t dq,
                                        const unsigned char* Ks,
                                        uint64_t* k_full, int t) {
  const int s = t % STAGES;
  mbar_wait(k_full + s, (t / STAGES) & 1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128_ss(sacc, dq + 2 * kk, sw128_desc(Ks + s * KV_BYTES) + 2 * kk,
                     kk);
  wgmma_commit();
}

// The logits of a 128-key tile from k0 (first key at grid cell (y0, x0))
// in place of S, in natural-log units: (q.k scale + Bh) + Bw, -inf for a
// key at or past n (MASKED: only the last tile has such keys); and each
// row's maximum. sacc[4 i + 2 h + j]: row h of the thread, key 8 i + 2 c + j.
// PAIRS: the tile spans at most two grid rows and its column pairs do not
// straddle one, so Bh takes two reads per row and Bw float2 reads.
template <bool PAIRS, bool MASKED>
__device__ __forceinline__ void tile_logits(float (&sacc)[64], float tmax[2],
                                            const float* const bh_row[2],
                                            const float* const bw_row[2],
                                            int k0, int y0, int x0, int n,
                                            int h_grid, int w_grid,
                                            float scale, int c) {
  tmax[0] = tmax[1] = -INFINITY;
  if (PAIRS) {
    float bhy[2][2];
    const int y1 = min(y0 + 1, h_grid - 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bhy[h][0] = bh_row[h][y0];
      bhy[h][1] = bh_row[h][y1];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * c;
      int x = x0 + col;
      const bool next_row = x >= w_grid;
      if (next_row) x -= w_grid;
      const bool ok = !MASKED || k0 + col < n;  // n even: both keys or none
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& l0 = sacc[4 * i + 2 * h];
        float& l1 = sacc[4 * i + 2 * h + 1];
        if (ok) {
          const float b = next_row ? bhy[h][1] : bhy[h][0];
          const float2 bwx = *reinterpret_cast<const float2*>(bw_row[h] + x);
          l0 = (l0 * scale + b) + bwx.x;
          l1 = (l1 * scale + b) + bwx.y;
        } else {
          l0 = l1 = -INFINITY;
        }
        tmax[h] = fmaxf(tmax[h], fmaxf(l0, l1));
      }
    }
  } else {
    int yr = y0, xr = x0 + 2 * c;  // a running grid cell per column
    while (xr >= w_grid) {
      xr -= w_grid;
      ++yr;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = !MASKED || k0 + 8 * i + 2 * c + j < n;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& l = sacc[4 * i + 2 * h + j];
          l = ok ? (l * scale + bh_row[h][yr]) + bw_row[h][xr] : -INFINITY;
          tmax[h] = fmaxf(tmax[h], l);
        }
        xr += j == 0 ? 1 : 7;
        while (xr >= w_grid) {
          xr -= w_grid;
          ++yr;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const float* __restrict__ bh,
                                const float* __restrict__ bw,
                                bf16* __restrict__ out,
                                float* __restrict__ lse, int n, int h_grid,
                                int w_grid, float scale, int pairs) {
  extern __shared__ unsigned char smem_raw[];
  // 1 KB alignment for the swizzled tiles
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + Q_BYTES;            // [STAGES][BN][64]
  unsigned char* Vs = Ks + STAGES * KV_BYTES;  // [STAGES][BN][64]
  const int lw = bias_ld(w_grid);
  const int lh = bias_ld(h_grid);
  float* bw_s = reinterpret_cast<float*>(Vs + STAGES * KV_BYTES);  // [BM][lw]
  float* bh_s = bw_s + BM * lw;                                    // [BM][lh]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bh_s + BM * lh);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int ntiles = (n + BN - 1) / BN;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMERS / 32);  // one arrival per warp
      mbar_init(v_empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the K/V ring full. K and V
    // stages are freed apart: K as soon as S is computed, V after P.V.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load_rows(Qs, &tm_q, q_full, q0, g);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const int parity = (t / STAGES - 1) & 1;
        if (t >= STAGES) mbar_wait(k_empty + s, parity);
        mbar_expect_tx(k_full + s, KV_BYTES);
        tma_load_rows(Ks + s * KV_BYTES, &tm_k, k_full + s, t * BN, g);
        if (t >= STAGES) mbar_wait(v_empty + s, parity);
        mbar_expect_tx(v_full + s, KV_BYTES);
        tma_load_rows(Vs + s * KV_BYTES, &tm_v, v_full + s, t * BN, g);
      }
    }
  } else {
    // ---- consumer warpgroups, 64 queries each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const size_t base = (size_t)g * n;
    // the block's bias rows (rows past n repeat row n - 1, never stored)
    for (int e = tid; e < BM * w_grid; e += CONSUMERS) {
      const int row = e / w_grid;
      const int x = e - row * w_grid;
      bw_s[row * lw + x] = bw[(base + min(q0 + row, n - 1)) * w_grid + x];
    }
    for (int e = tid; e < BM * h_grid; e += CONSUMERS) {
      const int row = e / h_grid;
      const int y = e - row * h_grid;
      bh_s[row * lh + y] = bh[(base + min(q0 + row, n - 1)) * h_grid + y];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;  // 16 rows each
    const int lane = tid % 32;
    const int c = lane % 4;
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int lrow[2] = {r0, r0 + 8};
    const float* const bw_row[2] = {bw_s + lrow[0] * lw, bw_s + lrow[1] * lw};
    const float* const bh_row[2] = {bh_s + lrow[0] * lh, bh_s + lrow[1] * lh};
    const uint64_t dq = sw128_desc(Qs + wg * 64 * ROW_BYTES);

    float m[2] = {-1e30f, -1e30f};  // running row maxima
    float den[2] = {0.f, 0.f};
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float sacc[64];
    uint32_t pa[8][4];

    mbar_wait(q_full, 0);
    issue_s(sacc, dq, Ks, k_full, 0);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) fence_regs(sacc[i]);
    if (lane == 0) mbar_arrive(k_empty);
    int y0 = 0, x0 = 0;  // grid cell of tile t's first key
    for (int t = 0; t < ntiles; ++t) {
      // the softmax of S_t runs while P_{t-1} V_{t-1} is on the tensor cores
      const int k0 = t * BN;
      float tmax[2];
      const bool masked = k0 + BN > n;
      if (pairs) {
        if (masked)
          tile_logits<true, true>(sacc, tmax, bh_row, bw_row, k0, y0, x0, n,
                                  h_grid, w_grid, scale, c);
        else
          tile_logits<true, false>(sacc, tmax, bh_row, bw_row, k0, y0, x0, n,
                                   h_grid, w_grid, scale, c);
      } else {
        if (masked)
          tile_logits<false, true>(sacc, tmax, bh_row, bw_row, k0, y0, x0, n,
                                   h_grid, w_grid, scale, c);
        else
          tile_logits<false, false>(sacc, tmax, bh_row, bw_row, k0, y0, x0,
                                    n, h_grid, w_grid, scale, c);
      }
      x0 += BN;  // the next tile's first key
      while (x0 >= w_grid) {
        x0 -= w_grid;
        ++y0;
      }
      // online softmax over the quad of lanes that share a row; exp2 of
      // log2(e)-scaled differences; P unrounded into the denominator
      float corr[2], mlog[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
        const float m_new = fmaxf(m[h], tmax[h]);
        corr[h] = ex2((m[h] - m_new) * LOG2E);
        m[h] = m_new;
        mlog[h] = m_new * LOG2E;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sacc[i] = ex2(fmaf(sacc[i], LOG2E, -mlog[(i / 2) % 2]));
        psum[(i / 2) % 2] += sacc[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
        psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
        den[h] = den[h] * corr[h] + psum[h];
      }
      // P_{t-1} V_{t-1} done (at t = 0 nothing is in flight): its V stage
      // and P are free. The waits are unconditional, so that ptxas sees
      // every read of an accumulator after the wait that retires it (a
      // read on a path without the wait serializes every wgmma: C7514)
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_regs(o[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_u32(pa[j][e]);
      if (t > 0 && lane == 0) mbar_arrive(v_empty + (t - 1) % STAGES);
      // P rounded to bf16 as the A operand of P.V: 8-key tiles 2j, 2j + 1
      // of S are k-step j
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        pa[i / 2][2 * (i % 2)] = pack_bf16(sacc[4 * i], sacc[4 * i + 1]);
        pa[i / 2][2 * (i % 2) + 1] =
            pack_bf16(sacc[4 * i + 2], sacc[4 * i + 3]);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i / 2) % 2];
      if (t + 1 < ntiles) issue_s(sacc, dq, Ks, k_full, t + 1);
      // O += P V: V [key][dim] is MN-major here; a k-step is 16 keys, 2048
      // bytes further
      const int s = t % STAGES;
      mbar_wait(v_full + s, (t / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_m64n64_rs_tb(o, pa[j],
                           sw128_desc(Vs + s * KV_BYTES) + j * (2048 >> 4), 1);
      wgmma_commit();
      // S_{t+1} done, P_t V_t may still run (after the last tile this
      // waits for nothing)
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_regs(sacc[i]);
      if (t + 1 < ntiles && lane == 0)
        mbar_arrive(k_empty + (t + 1) % STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_regs(o[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_u32(pa[j][e]);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = q0 + lrow[h];
      if (qr >= n) continue;
      bf16* orow = out + (base + qr) * HEAD_DIM + 2 * c;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(o[4 * i + 2 * h] / den[h], o[4 * i + 2 * h + 1] / den[h]);
      if (c == 0) lse[base + qr] = m[h] + logf(den[h]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint, so the
// build needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [G, N, 64] bf16 tensor as boxes of `rows` x 64, 128-byte swizzled,
// zero fill past N
bool rows_map(CUtensorMap* map, const void* ptr, int g, int n, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HEAD_DIM, (cuuint64_t)n,
                              (cuuint64_t)g};
  const cuuint64_t strides[2] = {(cuuint64_t)ROW_BYTES,
                                 (cuuint64_t)n * ROW_BYTES};
  const cuuint32_t box[3] = {(cuuint32_t)HEAD_DIM, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  CUtensorMap tm_q, tm_k, tm_v;
  if (!rows_map(&tm_q, q, g, n, BM) || !rows_map(&tm_k, k, g, n, BN) ||
      !rows_map(&tm_v, v, g, n, BN))
    return cudaErrorNotSupported;
  const int smem = fwd_smem_bytes(h_grid, w_grid);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, g);
  flash_attn_fwd_wgmma_kernel<<<grid, FWD_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(bh),
      static_cast<const float*>(bw), static_cast<bf16*>(out),
      static_cast<float*>(lse), n, h_grid, w_grid, scale,
      fwd_pairs_fit(w_grid) ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared memory (bytes) the kernel of this dtype (0 = float32,
// 1 = bfloat16) needs per block for this grid; the wrapper raises when it
// exceeds the card's 227 KB per block.
int aldi_flash_attn_fwd_smem(int h_grid, int w_grid, int dtype) {
  if (h_grid <= 0 || w_grid <= 0) return 0;
  return dtype == 0 ? 4 * TILE_FLOATS * (int)sizeof(float)
                    : fwd_smem_bytes(h_grid, w_grid);
}

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
