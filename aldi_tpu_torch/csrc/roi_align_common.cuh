// Shared by the ROIAlign forward (roi_align_fwd.cu) and backward
// (roi_align_bwd.cu) kernels: the pyramid description, dtype conversions
// and the sampling lattice of one box, so both kernels place and weight
// every bilinear sample identically.
//
// The lattice follows the corner-gather semantics of
// aldi_tpu/ops/roi_align.py:61-121:
//   - sample coordinate = box * (1/stride) - 0.5 + (bin + (s + 0.5)/sr) * bin
//   - a sample with c < -1 or c > size contributes 0 but counts in the mean
//   - otherwise c is clamped to [0, size-1] before the bilinear weights.
// Explicit _rn operations: no fused multiply-add, so the coordinates round
// exactly as the plain PyTorch version's do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi_align {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // output_size * sampling_ratio per axis

template <typename P>
struct Levels {
  P ptr[kMaxLevels];  // [B, H_l, W_l, C] contiguous
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
};

// level_ptrs: host array of num_levels device pointers; level_hw: host
// array of (H, W) pairs; level_scale: host array of 1/stride.
template <typename P>
inline Levels<P> make_levels(const void* level_ptrs, const void* level_hw,
                             const void* level_scale, int num_levels) {
  Levels<P> lv;
  const uint64_t* ptrs = static_cast<const uint64_t*>(level_ptrs);
  const int32_t* hw = static_cast<const int32_t*>(level_hw);
  const float* scale = static_cast<const float*>(level_scale);
  for (int l = 0; l < num_levels; ++l) {
    lv.ptr[l] = reinterpret_cast<P>(ptrs[l]);
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.scale[l] = scale[l];
  }
  return lv;
}

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

// Per axis (0 = y, box coords 1 and 3; 1 = x, box coords 0 and 2) and
// sample: the low and high corner index, the low-corner distance l (the
// weights are 1 - l and l) and whether the sample lies outside the level.
struct Lattice {
  int lo[2][kMaxSamples];
  int hi[2][kMaxSamples];
  float l[2][kMaxSamples];
  bool oob[2][kMaxSamples];
};

// Thread t < 2 * output_size * sampling_ratio fills one (axis, sample).
__device__ __forceinline__ void sample_point(Lattice& s, int t,
                                             const float* box, float scale,
                                             int H, int W, int output_size,
                                             int sampling_ratio) {
  const int S = output_size * sampling_ratio;
  const int axis = t / S;
  const int i = t % S;
  const float c0 = __fsub_rn(__fmul_rn(box[axis == 0 ? 1 : 0], scale), 0.5f);
  const float c1 = __fsub_rn(__fmul_rn(box[axis == 0 ? 3 : 2], scale), 0.5f);
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
  s.lo[axis][i] = low;
  s.hi[axis][i] = high;
  s.l[axis][i] = __fsub_rn(c, (float)low);
  s.oob[axis][i] = coord < -1.f || coord > (float)size;
}

// Threads per block: one per channel up to 256, at least one per
// (axis, sample), in whole warps.
inline int block_threads(int channels, int output_size, int sampling_ratio) {
  int threads = ((channels < 256 ? channels : 256) + 31) / 32 * 32;
  if (threads < 2 * output_size * sampling_ratio)
    threads = (2 * output_size * sampling_ratio + 31) / 32 * 32;
  return threads;
}

inline bool bad_args(int num_levels, int num_boxes, int channels,
                     int boxes_per_image, int output_size,
                     int sampling_ratio, int dtype) {
  return num_levels < 1 || num_levels > kMaxLevels ||
         output_size * sampling_ratio > kMaxSamples || num_boxes < 1 ||
         channels < 1 || boxes_per_image < 1 || (dtype != 0 && dtype != 1);
}

}  // namespace roi_align
