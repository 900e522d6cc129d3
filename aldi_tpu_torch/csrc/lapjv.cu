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
// One thread block per problem; each thread owns the columns j = tid,
// tid + blockDim, ... The per-column state (the column duals v, the
// shortest-path costs spc, the predecessor rows path, row4col and the
// settled flags) and the per-row state (the row duals u, col4row) live in
// shared memory when they fit in 48 KB (m = 300 queries: 6 KB), else in a
// global scratch buffer the wrapper allocates (the two-stage encoder's
// proposals, m = the encoder's tokens).
//
// Per row cur < n_rows[p], in index order: a Dijkstra from cur. Each settle
// relaxes every unsettled column through the current row i, each thread its
// own columns, and takes the minimal frontier column by a block-wide
// reduction of the key (masked spc, assigned, j) in lexicographic order:
// the least spc, among equal ones an unassigned column first, then the
// lowest index. That is the JAX function's tie rule: the first unassigned
// column among the minimal ones if there is one (argmax of tie_un), else
// the first minimal one (argmin). Warp shuffles, then one pass over the
// warps' results in shared memory. One thread settles the column and moves
// i to its owner, or stops at an unassigned column (the sink). Then the
// dual update (each thread its settled columns and their owner rows; the
// owners are distinct) and the augmentation walk back from the sink, by one
// thread.
//
// Exactness: the reduced cost is ((minv + cost[i][j]) - u[i]) - v[j] and
// the duals move by (u + minv) - spc and (v + spc) - minv, each operation
// rounded on its own (__fadd_rn, __fsub_rn: only adds and subtracts, no
// contraction), in the JAX function's order. Comparisons are of floats, so
// -0 and +0 tie as they do there. So col4row equals lapjv_plain's
// (ops/lapjv.py) and the JAX function's on every input, ties included.
//
// What bounds it on the card: latency. A problem's settles are sequential:
// two block barriers and one reduction each, about a microsecond, and a
// problem of 100 rows takes 100 to a few hundred of them; the problems run
// in parallel, one block each. The bytes it must move (the cost matrices
// read once, 2.9 MB at the published step's 24 problems of 100 x 300) take
// under a microsecond at the card's memory rate; PERF.md gives the time
// against that bound and the settles per problem.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;
constexpr size_t kSharedCap = 48 * 1024;
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kAssigned = 1 << 30;  // the tag's assigned bit, above any j

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

// Bytes of global scratch the wrapper must pass for P problems of [n, m]:
// 0 when a problem's state fits in shared memory.
size_t aldi_lapjv_scratch_bytes(int problems, int n, int m) {
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
  const size_t bytes = state_bytes(n, m);
  const bool in_shared = bytes <= kSharedCap;
  lapjv_kernel<<<problems, threads_for(m), in_shared ? bytes : 0, stream>>>(
      cost, n_rows, n, m, col4row, settles,
      in_shared ? nullptr : static_cast<unsigned char*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
