// Min-cost assignment (Jonker-Volgenant shortest augmenting paths) for
// NVIDIA Hopper (sm_90a), with a plain C interface loaded through ctypes by
// aldi_tpu_torch/ops/lapjv_kernel.py.
//
// K4 replaces aldi_tpu/ops/lapjv.py:97 lapjv (with :29 _assign_one_row),
// vmapped over the DETR criterion's L*B problems by
// aldi_tpu/models/detr.py:612: XLA while_loops there, not a Pallas kernel.
// In PyTorch that loop has no eager form that stays on the device (a host
// round trip per Dijkstra settle), so it is one kernel here.
//
// The algorithm. Per row cur < n_rows[p], in index order: a Dijkstra from
// cur. Each settle relaxes every unsettled column through the current row
// i (reduced cost ((minv + cost[i][j]) - u[i]) - v[j]) and settles the
// minimal frontier column by the key (masked spc, assigned, j) in
// lexicographic order: the least spc, among equal ones an unassigned
// column first, then the lowest index. That is the JAX function's tie rule:
// the first unassigned column among the minimal ones if there is one
// (argmax of tie_un), else the first minimal one (argmin). The search moves
// to the settled column's owner row, or stops at an unassigned column (the
// sink). Then the dual update and the augmentation walk back from the sink.
//
// What bounds it on the card: latency. A problem's settles form one
// sequential chain (each settle's row is the previous winner's owner), and
// a DETR problem of 100 pseudo-labels x 300 queries takes about 4,300 of
// them; the problems run side by side, one per SM. The bytes (the cost
// matrices read once, 2.9 MB at the published step's 24 problems) and the
// operations (5 per column per settle) take a few microseconds at the
// card's rates, so the time is the longest problem's settles times the
// latency of one settle.
//
// The design for m <= 512 (every shipped DETR config: m = the queries): one
// warp per problem, no barrier and no branch in the settle loop.
// - Lane l owns the columns j = l + 32k, k < CPL (a template: 4, 10, 16).
//   Their spc and v live in registers, their settled flags in a bit mask,
//   and each column's tag (assigned << 30) | (j << 10) | (owner row + 1):
//   the key's tie order, with the owner row carried along. The loops over
//   k unroll into selects, since the lanes' settled columns differ and a
//   branch on them would diverge the warp at every column.
// - The cost matrix's first n_rows rows are copied once into shared memory
//   (cp.async, a warp a row, 16 bytes a copy where the rows are aligned;
//   then 7 of the block's 8 warps exit), each row padded to 32 * CPL
//   floats, so that the row each settle reads, chosen by the data and
//   never known ahead, comes from shared memory at the row's base plus a
//   constant offset per column. Where the padded rows do not fit beside
//   the state in the SM's 227 KB, the row is read from global memory
//   (__ldg), one warp per block.
// - The argmin is two warp reductions: each lane's least masked spc (a
//   tree of FMNMX), __reduce_min_sync on the float's order-preserving
//   int32; then each lane's least tag among its columns equal to that
//   value as floats (so -0 and +0 tie, as in the JAX function), and
//   __reduce_min_sync on the tags, which gives the winner and its owner
//   row, the next row of the search, without a load.
// - A settle's loads are issued before its stores (the predecessor links
//   of the improved columns), which the compiler could not otherwise move
//   them past. A link packs the predecessor row with the column that row
//   held, so the walk back reads one word a step.
// So the settle loop is about 150 instructions of one warp: a row's loads
// from shared memory, three dependent adds per column across the lane's
// independent columns, two min trees and two REDUX. PERF.md gives the ns
// per settle measured on the card.
//
// For m > 512 (the two-stage encoder's proposals, TWO_STAGE, off in every
// shipped config) a lane would hold too many columns: one thread block per
// problem, each thread its own columns j = tid, tid + blockDim, ..., the
// state in shared memory when it fits in 48 KB, else in a global scratch
// buffer the wrapper allocates; per settle a block-wide reduction of the
// key (warp shuffles, then one pass over the warps' results) and one
// thread that settles, with two block barriers.
//
// Exactness: the reduced cost is ((minv + cost[i][j]) - u[i]) - v[j] and
// the duals move by (u + minv) - spc and (v + spc) - minv, each operation
// rounded on its own (__fadd_rn, __fsub_rn: only adds and subtracts, no
// contraction), in the JAX function's order. Comparisons are of floats, so
// -0 and +0 tie as they do there (a zero's sign never decides a compare,
// so the warp kernel's minv, a zero of either sign where the JAX function
// holds a zero, changes no assignment). So col4row and the settles equal
// lapjv_plain's (ops/lapjv.py) and the JAX function's col4row on every
// input, ties included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr size_t kSharedCap = 48 * 1024;
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kAssigned = 1 << 30;  // the tag's assigned bit, above any j

// the warp kernel: its widest m, the shared memory a block may take and the
// threads that copy the costs
constexpr int kWarpMaxCols = 512;
constexpr size_t kSmemMax = 232448;  // 227 KB
constexpr int kCopyThreads = 256;

// ------------------------------------------------------------ warp kernel

// The warp kernel's state in shared memory: u and col4row (n each), path
// and row4col (m each), 4 bytes an entry, rounded to 16.
__host__ __device__ inline size_t warp_state_bytes(int n, int m) {
  size_t b = 4 * (2 * (size_t)n + 2 * (size_t)m);
  return (b + 15) & ~(size_t)15;
}

// the columns a lane owns for m columns (m <= kWarpMaxCols)
__host__ inline int cols_per_lane(int m) {
  return m <= 128 ? 4 : (m <= 320 ? 10 : 16);
}

// The costs' rows in shared memory, each padded to the warp's 32 * CPL
// columns, so that a settle's loads are the row's base and a constant
// offset each.
__host__ inline size_t cost_bytes(int n, int m) {
  return 4 * (size_t)n * 32 * cols_per_lane(m);
}

__host__ inline bool costs_fit(int n, int m) {
  return cost_bytes(n, m) + warp_state_bytes(n, m) <= kSmemMax;
}

// x's bits as an int32 that orders as x does, but for -0 below +0: the
// argmin compares the winner's value to each column's as floats, so all
// zeros tie there as in the JAX function. The map is its own inverse.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// the least x of the warp's lanes
__device__ __forceinline__ int warp_min(int x) {
  return __reduce_min_sync(kFull, x);
}

__device__ __forceinline__ unsigned int warp_min(unsigned int x) {
  return __reduce_min_sync(kFull, x);
}

__device__ __forceinline__ void cp_async(unsigned int dst, const float* src,
                                         int bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

// The block's warps copy the first rows of the [*, m] costs at src
// (global) to dst (shared) at a row stride of stride floats, a warp a row,
// by cp.async: 16 bytes a copy where every row starts 16-byte aligned,
// else 4.
__device__ __forceinline__ void copy_costs(float* dst, const float* src,
                                           int rows, int m, int stride) {
  const unsigned int base =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const bool vec =
      (m & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int r = threadIdx.x >> 5; r < rows; r += warps) {
    const float* row = src + (size_t)r * m;
    const unsigned int out = base + 4u * (unsigned int)(r * stride);
    if (vec) {
      for (int c = 4 * lane; c < m; c += 128) {
        cp_async(out + 4 * c, row + c, 16);
      }
    } else {
      for (int c = lane; c < m; c += 32) cp_async(out + 4 * c, row + c, 4);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp per problem (block p). With kSharedCosts the block has
// kCopyThreads threads, which copy the costs; then warp 0 alone solves.
template <int CPL, bool kSharedCosts>
__global__ void __launch_bounds__(kCopyThreads)
    lapjv_warp_kernel(const float* __restrict__ cost,
                      const int* __restrict__ n_rows, int n, int m,
                      int* __restrict__ col4row_out,
                      int* __restrict__ settles_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  const float* c = cost + (size_t)p * n * m;
  const int limit = min(max(n_rows[p], 0), n);
  // the row stride of the costs the settles read
  const int stride = kSharedCosts ? 32 * CPL : m;

  float* s_cost = reinterpret_cast<float*>(smem);
  float* u = s_cost + (kSharedCosts ? (size_t)n * stride : 0);
  int* col4row = reinterpret_cast<int*>(u + n);
  int* path = col4row + n;
  int* row4col = path + m;
  if (kSharedCosts) {
    // only rows below limit are ever read: the search's rows are cur and
    // the owners of assigned columns, all rows already solved
    copy_costs(s_cost, c, limit, m, stride);
    __syncthreads();
    if (threadIdx.x >= 32) return;
  }
  const float* rows = kSharedCosts ? s_cost : c;
  const int lane = threadIdx.x;

  for (int j = lane; j < m; j += 32) row4col[j] = -1;
  for (int r = lane; r < n; r += 32) {
    u[r] = 0.0f;
    col4row[r] = -1;
  }
  // per column of the lane: v, spc, and its tag for the argmin, (assigned
  // << 30) | (j << 10) | (owner row + 1), which orders as the key's
  // (assigned, j) and carries the owner, so that the winner's owner comes
  // with the reduction and not from a load
  float v[CPL], spc[CPL];
  unsigned int tags[CPL];
  unsigned int valid = 0;  // bit k: column lane + 32k < m
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    v[k] = 0.0f;
    tags[k] = (unsigned int)(lane + 32 * k) << 10;
    if (lane + 32 * k < m) valid |= 1u << k;
  }
  int settles = 0;
  __syncwarp();

  for (int cur = 0; cur < limit; ++cur) {
    // ---- Dijkstra from cur; the columns past m count as settled
    unsigned int settled = ~valid;
#pragma unroll
    for (int k = 0; k < CPL; ++k) spc[k] = INFINITY;
    int i = cur, via = -1, sink = -1;  // via: the column whose owner is i
    float minv = 0.0f;
    while (true) {
      // every load of the settle first: the stores to path below may alias
      // them as far as the compiler knows, and would otherwise hold each
      // column's load behind the previous column's store. In shared memory
      // a column past m reads the row's padding, in global memory column
      // m - 1; either stays settled.
      const float* ci = rows + (size_t)i * stride;
      float cij[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        cij[k] = kSharedCosts ? ci[lane + 32 * k]
                              : __ldg(ci + min(lane + 32 * k, m - 1));
      }
      const float ui = u[i];
      // each improved column's link for the walk back: its predecessor row
      // i and the column that row holds, via (so the walk reads one word a
      // step; n, m <= 512 fit in 16 bits each)
      const int link = (i << 16) | (via + 1);
      // branch-free: the lanes' settled columns differ, and a branch on
      // them would diverge the warp at every column
      float masked[CPL], lane_min[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const bool open = !((settled >> k) & 1u);
        const float red =
            __fsub_rn(__fsub_rn(__fadd_rn(minv, cij[k]), ui), v[k]);
        const bool better = open && red < spc[k];
        spc[k] = better ? red : spc[k];
        if (better) path[lane + 32 * k] = link;
        masked[k] = open ? spc[k] : INFINITY;
        lane_min[k] = masked[k];
      }
      // the lane's least masked spc by a tree, then the warp's
#pragma unroll
      for (int s = 1; s < CPL; s *= 2) {
#pragma unroll
        for (int k = 0; k + s < CPL; k += 2 * s) {
          lane_min[k] = fminf(lane_min[k], lane_min[k + s]);
        }
      }
      const float best = key_value(warp_min(order_key(lane_min[0])));
      // the least tag among the tied columns (unassigned ones first, then
      // the lowest index) by a tree, then the warp's
      unsigned int cand[CPL];
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        cand[k] = masked[k] == best ? tags[k] : 0xffffffffu;
      }
#pragma unroll
      for (int s = 1; s < CPL; s *= 2) {
#pragma unroll
        for (int k = 0; k + s < CPL; k += 2 * s) {
          cand[k] = min(cand[k], cand[k + s]);
        }
      }
      const unsigned int tag = warp_min(cand[0]);
      const int j = (int)((tag >> 10) & 1023u);
      const int owner = (int)(tag & 1023u) - 1;
      settled |= lane == (j & 31) ? 1u << (j >> 5) : 0u;
      minv = best;
      ++settles;
      if (owner < 0) {
        sink = j;
        break;
      }
      i = owner;
      via = j;
    }

    // ---- dual update: cur and the owners of the settled assigned columns
    // (distinct rows, carried in the tags), before the augmentation
    // changes the owners; branch-free, the loads first
    float owner_u[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const bool take = (((settled & valid) >> k) & 1u) && (tags[k] >> 30);
      owner_u[k] = take ? u[(tags[k] & 1023u) - 1] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const bool done = ((settled & valid) >> k) & 1u;
      if (done && (tags[k] >> 30)) {
        u[(tags[k] & 1023u) - 1] =
            __fsub_rn(__fadd_rn(owner_u[k], minv), spc[k]);
      }
      v[k] = done ? __fsub_rn(__fadd_rn(v[k], spc[k]), minv) : v[k];
    }
    if (lane == 0) u[cur] = __fsub_rn(__fadd_rn(u[cur], minv), 0.0f);
    __syncwarp();

    // ---- augment: walk the links back from the sink (a row's column
    // before the walk is the link's via); the sink is the one column that
    // becomes assigned. Then each lane takes its columns' owners into
    // their tags
    if (lane == 0) {
      int j = sink;
      while (j >= 0) {
        const int link = path[j];
        const int r = link >> 16;
        row4col[j] = r;
        col4row[r] = j;
        j = (link & 0xffff) - 1;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      const int r = (valid >> k) & 1u ? row4col[j] : -1;
      tags[k] = (r >= 0 ? (unsigned int)kAssigned : 0u) |
                ((unsigned int)j << 10) | (unsigned int)(r + 1);
    }
  }

  for (int r = lane; r < n; r += 32) {
    col4row_out[(size_t)p * n + r] = col4row[r];
  }
  if (lane == 0) settles_out[p] = settles;
}

template <int CPL>
cudaError_t launch_warp(const float* cost, const int* n_rows, int problems,
                        int n, int m, int* col4row, int* settles,
                        cudaStream_t stream) {
  const size_t state = warp_state_bytes(n, m);
  if (costs_fit(n, m)) {
    auto kernel = lapjv_warp_kernel<CPL, true>;
    const size_t bytes = cost_bytes(n, m) + state;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<problems, kCopyThreads, bytes, stream>>>(cost, n_rows, n, m,
                                                      col4row, settles);
  } else {
    lapjv_warp_kernel<CPL, false><<<problems, 32, state, stream>>>(
        cost, n_rows, n, m, col4row, settles);
  }
  return cudaGetLastError();
}

// ----------------------------------------------------------- block kernel

// Bytes of one problem's state: four m-long 4-byte arrays, two n-long
// 4-byte arrays and the m settled flags, rounded to 16.
__host__ __device__ inline size_t state_bytes(int n, int m) {
  size_t b = 4 * (4 * (size_t)m + 2 * (size_t)n) + (size_t)m;
  return (b + 15) & ~(size_t)15;
}

struct Key {
  float val;
  int tag;  // (assigned ? kAssigned : 0) | j
};

__device__ __forceinline__ bool key_less(Key a, Key b) {
  return a.val < b.val || (a.val == b.val && a.tag < b.tag);
}

__device__ __forceinline__ Key warp_min(Key k) {
  for (int off = 16; off > 0; off >>= 1) {
    Key o;
    o.val = __shfl_down_sync(kFull, k.val, off);
    o.tag = __shfl_down_sync(kFull, k.tag, off);
    if (key_less(o, k)) k = o;
  }
  return k;
}

__global__ void lapjv_kernel(const float* __restrict__ cost,
                             const int* __restrict__ n_rows, int n, int m,
                             int* __restrict__ col4row_out,
                             int* __restrict__ settles_out,
                             unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Key warp_keys[kMaxWarps];
  __shared__ int s_i, s_sink;
  __shared__ float s_minv;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const float* c = cost + (size_t)p * n * m;

  unsigned char* base =
      scratch ? scratch + (size_t)p * state_bytes(n, m) : smem;
  float* v = reinterpret_cast<float*>(base);
  float* spc = v + m;
  int* path = reinterpret_cast<int*>(spc + m);
  int* row4col = path + m;
  float* u = reinterpret_cast<float*>(row4col + m);
  int* col4row = reinterpret_cast<int*>(u + n);
  unsigned char* settled = reinterpret_cast<unsigned char*>(col4row + n);

  for (int j = tid; j < m; j += nthreads) {
    v[j] = 0.0f;
    row4col[j] = -1;
  }
  for (int r = tid; r < n; r += nthreads) {
    u[r] = 0.0f;
    col4row[r] = -1;
  }
  const int limit = min(max(n_rows[p], 0), n);
  int settles = 0;

  for (int cur = 0; cur < limit; ++cur) {
    for (int j = tid; j < m; j += nthreads) {
      spc[j] = INFINITY;
      path[j] = -1;
      settled[j] = 0;
    }
    if (tid == 0) {
      s_i = cur;
      s_sink = -1;
      s_minv = 0.0f;
    }
    __syncthreads();

    // ---- Dijkstra from cur
    while (true) {
      const int i = s_i;
      const float minv = s_minv;
      const float ui = u[i];
      const float* ci = c + (size_t)i * m;
      Key best;
      best.val = INFINITY;
      best.tag = 0x7fffffff;
      for (int j = tid; j < m; j += nthreads) {
        float masked = INFINITY;
        if (!settled[j]) {
          float red = __fsub_rn(__fsub_rn(__fadd_rn(minv, ci[j]), ui), v[j]);
          float s = spc[j];
          if (red < s) {
            s = red;
            spc[j] = red;
            path[j] = i;
          }
          masked = s;
        }
        Key k;
        k.val = masked;
        k.tag = (row4col[j] == -1 ? 0 : kAssigned) | j;
        if (key_less(k, best)) best = k;
      }
      best = warp_min(best);
      if (lane == 0) warp_keys[warp] = best;
      __syncthreads();
      if (warp == 0) {
        Key k;
        k.val = INFINITY;
        k.tag = 0x7fffffff;
        if (lane < nwarps) k = warp_keys[lane];
        k = warp_min(k);
        if (lane == 0) {
          const int j = k.tag & (kAssigned - 1);
          settled[j] = 1;
          s_minv = k.val;
          const int owner = row4col[j];
          if (owner < 0) {
            s_sink = j;
          } else {
            s_i = owner;
          }
          ++settles;
        }
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }

    // ---- dual update: cur and the owners of the settled assigned columns
    const float minv = s_minv;
    for (int j = tid; j < m; j += nthreads) {
      if (settled[j]) {
        const float s = spc[j];
        const int r = row4col[j];
        if (r >= 0) u[r] = __fsub_rn(__fadd_rn(u[r], minv), s);
        v[j] = __fsub_rn(__fadd_rn(v[j], s), minv);
      }
    }
    if (tid == 0) u[cur] = __fsub_rn(__fadd_rn(u[cur], minv), 0.0f);
    __syncthreads();

    // ---- augment: walk the predecessor rows back from the sink
    if (tid == 0) {
      int j = s_sink;
      while (j >= 0) {
        const int r = path[j];
        row4col[j] = r;
        const int next = col4row[r];
        col4row[r] = j;
        j = next;
      }
    }
    __syncthreads();
  }

  for (int r = tid; r < n; r += nthreads) {
    col4row_out[(size_t)p * n + r] = col4row[r];
  }
  if (tid == 0) settles_out[p] = settles;
}

int threads_for(int m) {
  int t = ((m + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

}  // namespace

extern "C" {

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Which kernel aldi_lapjv launches for problems of [n, m].
const char* aldi_lapjv_kernel_name(int n, int m) {
  if (m > kWarpMaxCols) return "block per problem";
  static const char* names[3][2] = {
      {"warp per problem, 4 columns a lane, costs in global memory",
       "warp per problem, 4 columns a lane, costs in shared memory"},
      {"warp per problem, 10 columns a lane, costs in global memory",
       "warp per problem, 10 columns a lane, costs in shared memory"},
      {"warp per problem, 16 columns a lane, costs in global memory",
       "warp per problem, 16 columns a lane, costs in shared memory"}};
  const int cpl = cols_per_lane(m);
  return names[cpl == 4 ? 0 : (cpl == 10 ? 1 : 2)][costs_fit(n, m)];
}

// Bytes of global scratch the wrapper must pass for P problems of [n, m]:
// 0 when the warp kernel runs or a problem's state fits in shared memory.
size_t aldi_lapjv_scratch_bytes(int problems, int n, int m) {
  if (m <= kWarpMaxCols) return 0;
  size_t b = state_bytes(n, m);
  return b <= kSharedCap ? 0 : (size_t)problems * b;
}

// cost [P, n, m] float32 (n <= m, finite), n_rows [P] int32 -> col4row
// [P, n] int32 (-1 beyond n_rows), settles [P] int32. ``scratch`` holds
// aldi_lapjv_scratch_bytes(P, n, m) bytes (may be null when that is 0).
int aldi_lapjv(const float* cost, const int* n_rows, int problems, int n,
               int m, int* col4row, int* settles, void* scratch,
               cudaStream_t stream) {
  if (problems == 0) return 0;
  if (m <= kWarpMaxCols) {
    const int cpl = cols_per_lane(m);
    cudaError_t err =
        cpl == 4    ? launch_warp<4>(cost, n_rows, problems, n, m, col4row,
                                     settles, stream)
        : cpl == 10 ? launch_warp<10>(cost, n_rows, problems, n, m, col4row,
                                      settles, stream)
                    : launch_warp<16>(cost, n_rows, problems, n, m, col4row,
                                      settles, stream);
    return static_cast<int>(err);
  }
  const size_t bytes = state_bytes(n, m);
  const bool in_shared = bytes <= kSharedCap;
  lapjv_kernel<<<problems, threads_for(m), in_shared ? bytes : 0, stream>>>(
      cost, n_rows, n, m, col4row, settles,
      in_shared ? nullptr : static_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
