// The pointwise work that follows a convolution, in one pass over the
// conv's NHWC output, for NVIDIA Hopper (sm_90a), with a plain C interface
// loaded through ctypes by aldi_tpu_torch/ops/conv_epilogue_kernel.py.
//
// No TPU kernel is replaced: the JAX package leaves a conv and what follows
// it to XLA, which fuses them. On the card PyTorch runs the conv's bias,
// the ReLU, a residual add and the FPN's nearest-2x top-down add as
// separate passes over the largest tensors of the R-CNN trunks; this file
// runs them as one.
//
// Forward, in place on y (NHWC, bfloat16 or float32, [rows, C] with rows =
// N*H*W), with a float32 per-channel bias b, in one of four forms:
//   y + b;  relu(y + b);  relu(y + b + r);  y + b + m[n, h/2, w/2],
// computed in float32 registers in that order and rounded once. r is a
// tensor of y's shape and dtype (a residual), m a coarser map of half y's
// height and width (the FPN's merged level, read at (h/2, w/2): the
// upsampled tensor is never made).
//
// Backward, for the gradient g of the forward's output: gy = g, zeroed
// where the saved output is <= 0 (PyTorch's ReLU backward) if the forward
// had a ReLU; the bias gradient, the sum of gy over rows in float32; the
// coarse map's gradient, the sum of gy over each 2x2 cell, in float32 and
// rounded once. All in one pass over g; the bias sums go
// through per-block partial rows summed in a fixed order by a second
// kernel, so two launches on the same inputs give the same bits.
//
// What bounds it on the card: the bytes it moves, a few float operations
// an element. Design: 16-byte loads and stores along C (8 bfloat16 or 4
// float32 channels a thread); each thread keeps one channel group, and its
// bias, in registers while it strides over rows, so the grid's row stride
// is a multiple of nothing but the block's rows; no shared memory in the
// forward. A channel count that is not a multiple of the vector, or an
// operand that is not 16-byte aligned, takes the same kernels one channel
// a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // 2048 resident threads of 256 a block

template <typename T, int V>
struct Pack;

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = *p;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

// the row of the coarse map (half the height and width) under fine row
__device__ __forceinline__ long long coarse_row(long long row, int H, int W) {
  const long long hw = (long long)H * W;
  const long long n = row / hw;
  const int rem = (int)(row - n * hw);
  const int h = rem / W;
  const int w = rem - h * W;
  return (n * (H >> 1) + (h >> 1)) * (long long)(W >> 1) + (w >> 1);
}

template <typename T, int V, bool RES, bool COARSE, bool RELU>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_fwd_kernel(T* y, const float* __restrict__ bias,
                             const T* __restrict__ r,
                             const T* __restrict__ m, long long rows, int H,
                             int W, int C) {
  const int groups = C / V;
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int c0 = g * V;
    float b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) b[k] = bias[c0 + k];
    for (long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
         row < rows; row += stride) {
      const long long off = row * C + c0;
      float v[V];
      Pack<T, V>::load(y + off, v);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] += b[k];
      if (RES) {
        float t[V];
        Pack<T, V>::load(r + off, t);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] += t[k];
      }
      if (COARSE) {
        float t[V];
        Pack<T, V>::load(m + coarse_row(row, H, W) * C + c0, t);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] += t[k];
      }
      if (RELU) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = v[k] < 0.f ? 0.f : v[k];
      }
      Pack<T, V>::store(y + off, v);
    }
  }
}

// One cell is one row of g (COARSE false) or the 2x2 rows under one row
// of the coarse map (COARSE true). Each block walks its cells for one
// channel group at a time; with BIAS its threads' sums are reduced over
// the block's rows in shared memory, in a fixed order, into the block's
// partial row.
template <typename T, int V, bool RELU, bool BIAS, bool COARSE>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_bwd_kernel(const T* __restrict__ g,
                             const T* __restrict__ out, T* __restrict__ gy,
                             float* __restrict__ partial,
                             T* __restrict__ gm, long long cells, int H,
                             int W, int C) {
  __shared__ float sums[BIAS ? kThreads * V : 1];
  const int groups = C / V;
  const long long stride = (long long)gridDim.x * blockDim.y;
  const int Wc = W >> 1;
  for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
    const int grp = g0 + threadIdx.x;
    const bool active = grp < groups;
    const int c0 = grp * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (long long cell = (long long)blockIdx.x * blockDim.y + threadIdx.y;
         active && cell < cells; cell += stride) {
      float cm[V];
#pragma unroll
      for (int k = 0; k < V; ++k) cm[k] = 0.f;
#pragma unroll
      for (int q = 0; q < (COARSE ? 4 : 1); ++q) {
        long long row = cell;
        if (COARSE) {
          const long long nh = cell / Wc;  // n * (H / 2) + i
          const int j = (int)(cell - nh * Wc);
          row = (2 * nh + (q >> 1)) * W + 2 * j + (q & 1);
        }
        const long long off = row * C + c0;
        float v[V];
        Pack<T, V>::load(g + off, v);
        if (RELU) {
          float o[V];
          Pack<T, V>::load(out + off, o);
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = o[k] <= 0.f ? 0.f : v[k];
          Pack<T, V>::store(gy + off, v);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (BIAS) acc[k] += v[k];
          if (COARSE) cm[k] += v[k];
        }
      }
      if (COARSE) Pack<T, V>::store(gm + cell * C + c0, cm);
    }
    if (BIAS) {
      const int t = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
      for (int k = 0; k < V; ++k) sums[t * V + k] = acc[k];
      __syncthreads();
      if (threadIdx.y == 0 && active) {
        float s[V];
#pragma unroll
        for (int k = 0; k < V; ++k) s[k] = 0.f;
        for (int y = 0; y < blockDim.y; ++y) {
          const int u = y * blockDim.x + threadIdx.x;
#pragma unroll
          for (int k = 0; k < V; ++k) s[k] += sums[u * V + k];
        }
#pragma unroll
        for (int k = 0; k < V; ++k)
          partial[(long long)blockIdx.x * C + c0 + k] = s[k];
      }
      __syncthreads();
    }
  }
}

// gb[c] = the sum of the partial rows' column c, in the rows' order
__global__ void conv_epilogue_bias_sum_kernel(const float* __restrict__ partial,
                                              int parts, int C,
                                              float* __restrict__ gb) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += partial[(long long)p * C + c];
  gb[c] = s;
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      n = 132;
    count[dev] = n;
  }
  return count[dev];
}

// threads (x: channel groups, y: rows) and blocks for `units` rows or
// cells of `groups` channel groups, at most `max_blocks` blocks
void shape(long long units, int groups, int max_blocks, dim3* block,
           dim3* grid) {
  const int bx = groups < kThreads ? groups : kThreads;
  const int by = kThreads / bx;
  long long blocks = (units + by - 1) / by;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  *block = dim3(bx, by);
  *grid = dim3((unsigned)blocks);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int V>
cudaError_t launch_fwd(void* y, const float* bias, const void* r,
                       const void* m, long long rows, int H, int W, int C,
                       int relu, cudaStream_t stream) {
  dim3 block, grid;
  shape(rows, C / V, sm_count() * kBlocksPerSm, &block, &grid);
  T* yt = static_cast<T*>(y);
  const T* rt = static_cast<const T*>(r);
  const T* mt = static_cast<const T*>(m);
#define ALDI_FWD(RES, COARSE, RELU)                                        \
  conv_epilogue_fwd_kernel<T, V, RES, COARSE, RELU>                        \
      <<<grid, block, 0, stream>>>(yt, bias, rt, mt, rows, H, W, C)
  if (r != nullptr) {
    ALDI_FWD(true, false, true);  // bias + residual + ReLU
  } else if (m != nullptr) {
    ALDI_FWD(false, true, false);  // bias + top-down add
  } else if (relu) {
    ALDI_FWD(false, false, true);  // bias + ReLU
  } else {
    ALDI_FWD(false, false, false);  // bias
  }
#undef ALDI_FWD
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd(const void* g, const void* out, void* gy, float* gb,
                       void* gm, float* partial, int parts, long long rows,
                       int H, int W, int C, cudaStream_t stream) {
  const bool coarse = gm != nullptr;
  const long long cells = coarse ? rows / 4 : rows;
  dim3 block, grid;
  shape(cells, C / V, gb != nullptr ? parts : sm_count() * kBlocksPerSm,
        &block, &grid);
  const T* gt = static_cast<const T*>(g);
  const T* ot = static_cast<const T*>(out);
  T* gyt = static_cast<T*>(gy);
  T* gmt = static_cast<T*>(gm);
#define ALDI_BWD(RELU, BIAS, COARSE)                                       \
  conv_epilogue_bwd_kernel<T, V, RELU, BIAS, COARSE>                       \
      <<<grid, block, 0, stream>>>(gt, ot, gyt, partial, gmt, cells, H, W, \
                                   C)
  if (out != nullptr) {  // the ReLU forms
    if (gb != nullptr) {
      ALDI_BWD(true, true, false);
    } else {
      ALDI_BWD(true, false, false);
    }
  } else if (coarse) {  // the top-down form
    if (gb != nullptr) {
      ALDI_BWD(false, true, true);
    } else {
      ALDI_BWD(false, false, true);
    }
  } else {  // the bias form
    ALDI_BWD(false, true, false);
  }
#undef ALDI_BWD
  if (gb != nullptr) {
    conv_epilogue_bias_sum_kernel<<<(C + kThreads - 1) / kThreads, kThreads,
                                    0, stream>>>(partial, (int)grid.x, C, gb);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [rows, C] in place; bias [C] float32; r [rows, C] or null; m
// [rows / 4, C] (the coarse map of an N x H x W grid) or null; dtype 0
// float32, 1 bfloat16. The four forms: bias, bias + ReLU, bias + r +
// ReLU, bias + m; any other combination is refused.
int aldi_conv_epilogue(void* y, const float* bias, const void* r,
                       const void* m, long long rows, int H, int W, int C,
                       int relu, int dtype, void* stream) {
  if ((r != nullptr && (m != nullptr || !relu)) || (m != nullptr && relu))
    return cudaErrorInvalidValue;
  if (m != nullptr && ((H & 1) || (W & 1))) return cudaErrorInvalidValue;
  if (rows <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? 8 : 4;
  const bool wide = C % vec == 0 && aligned(y) && aligned(r) && aligned(m);
  if (dtype == 1) {
    return wide ? launch_fwd<__nv_bfloat16, 8>(y, bias, r, m, rows, H, W, C,
                                               relu, s)
                : launch_fwd<__nv_bfloat16, 1>(y, bias, r, m, rows, H, W, C,
                                               relu, s);
  }
  return wide ? launch_fwd<float, 4>(y, bias, r, m, rows, H, W, C, relu, s)
              : launch_fwd<float, 1>(y, bias, r, m, rows, H, W, C, relu, s);
}

// g [rows, C]; out (the forward's output, for a ReLU's mask) and gy
// [rows, C], both null or both given; gb [C] float32 or null, with
// partial [parts, C] float32 scratch (parts >= 1: one row for each block
// of the pass, which launches at most parts blocks); gm [rows / 4, C] or
// null, and then no out (the forward's forms). At least one of gy, gb, gm.
int aldi_conv_epilogue_bwd(const void* g, const void* out, void* gy,
                           float* gb, void* gm, float* partial, int parts,
                           long long rows, int H, int W, int C, int dtype,
                           void* stream) {
  if ((out == nullptr) != (gy == nullptr) || (out != nullptr && gm) ||
      (out == nullptr && gb == nullptr && gm == nullptr) ||
      (gb != nullptr && (partial == nullptr || parts < 1)))
    return cudaErrorInvalidValue;
  if (gm != nullptr && ((H & 1) || (W & 1))) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) {
    if (gb != nullptr && C > 0) return cudaMemsetAsync(gb, 0, C * 4, s);
    return 0;
  }
  const int vec = dtype == 1 ? 8 : 4;
  const bool wide = C % vec == 0 && aligned(g) && aligned(out) &&
                    aligned(gy) && aligned(gm);
  if (dtype == 1) {
    return wide ? launch_bwd<__nv_bfloat16, 8>(g, out, gy, gb, gm, partial,
                                               parts, rows, H, W, C, s)
                : launch_bwd<__nv_bfloat16, 1>(g, out, gy, gb, gm, partial,
                                               parts, rows, H, W, C, s);
  }
  return wide ? launch_bwd<float, 4>(g, out, gy, gb, gm, partial, parts,
                                     rows, H, W, C, s)
              : launch_bwd<float, 1>(g, out, gy, gb, gm, partial, parts,
                                     rows, H, W, C, s);
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
