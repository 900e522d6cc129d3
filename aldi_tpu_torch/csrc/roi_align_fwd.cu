// Multi-level aligned ROIAlign forward (7x7 output, sampling ratio 2) for
// NVIDIA Hopper (sm_90a), with a plain C interface loaded through ctypes by
// aldi_tpu_torch/ops/roi_align_kernel.py.
//
// Replaces the Pallas TPU kernel aldi_tpu/ops/pallas_roi_align.py:183
// (_roi_align_pallas_flat with _fine_kernel and _resident_kernel) and
// computes what it computes, the corner-gather semantics of
// aldi_tpu/ops/roi_align.py:61-121:
//   - sample coordinate = box * (1/stride) - 0.5 + (bin + (s + 0.5)/sr) * bin
//   - a sample with c < -1 or c > size contributes 0 but counts in the mean
//   - otherwise c is clamped to [0, size-1] before the bilinear weights
//   - a box with level -1 (invalid) gives all zeros.
// The level of each box is computed once in torch and passed in: log2/sqrt
// computed here could round a box onto another pyramid level.
//
// What bounds it on the card: the bytes it moves, with its float32
// operations close behind. It writes every output element once (B*P*49*C
// elements) and reads the feature rows its samples touch; per output
// element it does 8 float operations for each of its 4 samples, near the
// ~20 operations per byte at which an H100 stops being bound by memory.
// Design: one block per box over the flattened B*P boxes; the block first
// puts the box's 2x14 sample coordinates, corner indices and weights in
// shared memory, then its threads walk the channels, so neighbouring
// threads read neighbouring NHWC addresses (coalesced row reads) and each
// thread accumulates its 49 bins x 4 samples x 4 corners in float32 and
// writes the features' dtype. The TPU kernel's window DMAs, iota weight
// matrices and MXU products are TPU devices with no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // output_size * sampling_ratio per axis

struct Levels {
  const void* ptr[kMaxLevels];  // [B, H_l, W_l, C] contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void roi_align_fwd_kernel(Levels lv, const float* __restrict__ boxes,
                                     const int* __restrict__ levels,
                                     int boxes_per_image, int channels,
                                     int output_size, int sampling_ratio,
                                     T* __restrict__ out) {
  __shared__ int s_lo[2][kMaxSamples];
  __shared__ int s_hi[2][kMaxSamples];
  __shared__ float s_l[2][kMaxSamples];
  __shared__ bool s_oob[2][kMaxSamples];

  const int n = blockIdx.x;
  const int lvl = levels[n];
  const int bins = output_size * output_size;
  T* o = out + (size_t)n * bins * channels;
  if (lvl < 0) {
    for (int i = threadIdx.x; i < bins * channels; i += blockDim.x)
      o[i] = from_f32<T>(0.f);
    return;
  }

  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  const int S = output_size * sampling_ratio;
  if (threadIdx.x < 2 * S) {
    // axis 0 = y (box coords 1, 3), axis 1 = x (box coords 0, 2).
    // Explicit _rn operations: no fused multiply-add, so the coordinates
    // round exactly as the plain PyTorch version's do.
    const int axis = threadIdx.x / S;
    const int i = threadIdx.x % S;
    const float scale = lv.scale[lvl];
    const float* b = boxes + (size_t)n * 4;
    const float c0 = __fsub_rn(__fmul_rn(b[axis == 0 ? 1 : 0], scale), 0.5f);
    const float c1 = __fsub_rn(__fmul_rn(b[axis == 0 ? 3 : 2], scale), 0.5f);
    const float bin_size = __fdiv_rn(__fsub_rn(c1, c0), (float)output_size);
    const float frac = __fadd_rn(
        (float)(i / sampling_ratio),
        __fdiv_rn((float)(i % sampling_ratio) + 0.5f, (float)sampling_ratio));
    const float coord = __fadd_rn(c0, __fmul_rn(frac, bin_size));
    const int size = axis == 0 ? H : W;
    float c = fmaxf(coord, 0.f);
    int low = min((int)c, size - 1);
    int high;
    if (low >= size - 1) {
      low = size - 1;
      high = size - 1;
      c = (float)low;
    } else {
      high = low + 1;
    }
    s_lo[axis][i] = low;
    s_hi[axis][i] = high;
    s_l[axis][i] = __fsub_rn(c, (float)low);
    s_oob[axis][i] = coord < -1.f || coord > (float)size;
  }
  __syncthreads();

  const T* feat = static_cast<const T*>(lv.ptr[lvl]) +
                  (size_t)(n / boxes_per_image) * H * W * channels;
  const float inv_count = 1.f / (float)(sampling_ratio * sampling_ratio);
  for (int ch = threadIdx.x; ch < channels; ch += blockDim.x) {
    const T* f = feat + ch;
    for (int oy = 0; oy < output_size; ++oy) {
      for (int ox = 0; ox < output_size; ++ox) {
        float acc = 0.f;
        for (int sy = 0; sy < sampling_ratio; ++sy) {
          const int iy = oy * sampling_ratio + sy;
          if (s_oob[0][iy]) continue;
          const float ly = s_l[0][iy];
          const float hy = __fsub_rn(1.f, ly);
          const size_t r0 = (size_t)s_lo[0][iy] * W;
          const size_t r1 = (size_t)s_hi[0][iy] * W;
          for (int sx = 0; sx < sampling_ratio; ++sx) {
            const int ix = ox * sampling_ratio + sx;
            if (s_oob[1][ix]) continue;
            const float lx = s_l[1][ix];
            const float hx = __fsub_rn(1.f, lx);
            const size_t x0 = s_lo[1][ix];
            const size_t x1 = s_hi[1][ix];
            const float v00 = to_f32(f[(r0 + x0) * channels]);
            const float v01 = to_f32(f[(r0 + x1) * channels]);
            const float v10 = to_f32(f[(r1 + x0) * channels]);
            const float v11 = to_f32(f[(r1 + x1) * channels]);
            float s = __fmul_rn(v00, __fmul_rn(hy, hx));
            s = __fadd_rn(s, __fmul_rn(v01, __fmul_rn(hy, lx)));
            s = __fadd_rn(s, __fmul_rn(v10, __fmul_rn(ly, hx)));
            s = __fadd_rn(s, __fmul_rn(v11, __fmul_rn(ly, lx)));
            acc = __fadd_rn(acc, s);
          }
        }
        o[(oy * output_size + ox) * channels + ch] =
            from_f32<T>(__fmul_rn(acc, inv_count));
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. level_ptrs is a host array of
// num_levels device pointers, level_hw a host array of (H, W) pairs,
// level_scale a host array of 1/stride. boxes [num_boxes, 4] f32 and levels
// [num_boxes] int32 are on the device; box n belongs to image
// n / boxes_per_image. out is [num_boxes, output_size, output_size,
// channels] in dtype. Returns cudaGetLastError() after the launch.
int aldi_roi_align_fwd(const void* level_ptrs, const void* level_hw,
                       const void* level_scale, int num_levels,
                       const void* boxes, const void* levels,
                       int boxes_per_image, int num_boxes, int channels,
                       int output_size, int sampling_ratio, int dtype,
                       void* out, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels ||
      output_size * sampling_ratio > kMaxSamples || num_boxes < 1 ||
      channels < 1 || boxes_per_image < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  const uint64_t* ptrs = static_cast<const uint64_t*>(level_ptrs);
  const int32_t* hw = static_cast<const int32_t*>(level_hw);
  const float* scale = static_cast<const float*>(level_scale);
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = reinterpret_cast<const void*>(ptrs[l]);
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.scale[l] = scale[l];
  }
  int threads = ((channels < 256 ? channels : 256) + 31) / 32 * 32;
  if (threads < 2 * output_size * sampling_ratio)
    threads = (2 * output_size * sampling_ratio + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  if (dtype == 0)
    roi_align_fwd_kernel<float><<<num_boxes, threads, 0, s>>>(
        lv, b, lvl, boxes_per_image, channels, output_size, sampling_ratio,
        static_cast<float*>(out));
  else
    roi_align_fwd_kernel<__nv_bfloat16><<<num_boxes, threads, 0, s>>>(
        lv, b, lvl, boxes_per_image, channels, output_size, sampling_ratio,
        static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
