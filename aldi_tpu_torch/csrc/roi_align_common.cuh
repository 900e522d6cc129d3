// Shared by the ROIAlign forward (roi_align_fwd.cu) and backward
// (roi_align_bwd.cu) kernels: the pyramid description, dtype conversions,
// 16-byte channel vectors and the sampling lattice of one box, so both
// kernels place and weight every bilinear sample identically.
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

#include <type_traits>

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

// Whether every level pointer is 16-byte aligned (the vector paths).
inline bool levels_aligned(const void* level_ptrs, int num_levels) {
  const uint64_t* ptrs = static_cast<const uint64_t*>(level_ptrs);
  for (int l = 0; l < num_levels; ++l)
    if (ptrs[l] % 16) return false;
  return true;
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

// A vector of N channels of T as it sits in memory: N = 1 is one scalar,
// otherwise 16 bytes (4 float32 or 8 bfloat16 channels, one 128-bit load
// or store per lane).
template <typename T, int N>
using Raw = typename std::conditional<N == 1, T, uint4>::type;

template <typename T, int N>
__device__ __forceinline__ Raw<T, N> load_raw(const T* p) {
  if constexpr (N == 1) {
    return __ldg(p);
  } else {
    static_assert(N * sizeof(T) == 16, "16-byte vectors only");
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

// Channel e of a loaded vector, in float32 (exactly __bfloat162float).
template <typename T, int N>
__device__ __forceinline__ float channel(const Raw<T, N>& r, int e) {
  if constexpr (N == 1) {
    return to_f32(r);
  } else {
    const int word = e / (N / 4);  // 4 words of 32 bits
    const uint32_t u = word == 0 ? r.x : word == 1 ? r.y : word == 2 ? r.z
                                                                      : r.w;
    if constexpr (std::is_same<T, float>::value) {
      return __uint_as_float(u);
    } else {  // bfloat16: the even channel in the low half
      return __uint_as_float(e % 2 == 0 ? u << 16 : u & 0xffff0000u);
    }
  }
}

// Store N float32 values as N channels of T (round to nearest even).
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  if constexpr (N == 1) {
    *p = from_f32<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One sample of one axis (0 = y, box coords 1 and 3; 1 = x, box coords 0
// and 2): the low and high corner index, the low-corner distance l (the
// weights are 1 - l and l) and whether the sample lies outside the level.
// lo and hi always lie in [0, size - 1], also for a sample outside it.
struct Sample {
  int lo;
  int hi;
  float l;
  bool oob;
};

__device__ __forceinline__ Sample sample_at(const float* box, int axis,
                                            int i, float scale, int size,
                                            int output_size,
                                            int sampling_ratio) {
  const float c0 = __fsub_rn(__fmul_rn(box[axis == 0 ? 1 : 0], scale), 0.5f);
  const float c1 = __fsub_rn(__fmul_rn(box[axis == 0 ? 3 : 2], scale), 0.5f);
  const float bin_size = __fdiv_rn(__fsub_rn(c1, c0), (float)output_size);
  const float frac = __fadd_rn(
      (float)(i / sampling_ratio),
      __fdiv_rn((float)(i % sampling_ratio) + 0.5f, (float)sampling_ratio));
  const float coord = __fadd_rn(c0, __fmul_rn(frac, bin_size));
  float c = fmaxf(coord, 0.f);
  Sample s;
  s.lo = min((int)c, size - 1);
  if (s.lo >= size - 1) {
    s.lo = size - 1;
    s.hi = size - 1;
    c = (float)s.lo;
  } else {
    s.hi = s.lo + 1;
  }
  s.l = __fsub_rn(c, (float)s.lo);
  s.oob = coord < -1.f || coord > (float)size;
  return s;
}

inline bool bad_args(int num_levels, int num_boxes, int channels,
                     int boxes_per_image, int output_size,
                     int sampling_ratio, int dtype) {
  return num_levels < 1 || num_levels > kMaxLevels || output_size < 1 ||
         sampling_ratio < 1 || output_size * sampling_ratio > kMaxSamples ||
         num_boxes < 1 || channels < 1 || boxes_per_image < 1 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace roi_align
