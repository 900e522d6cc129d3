// The previous ROIAlign forward kernel (one block per box, one thread per
// channel, scalar loads), kept for
// aldi_tpu_torch/tools/kernel_variants.py to time beside the current
// source in one process. Built with -I aldi_tpu_torch/csrc; its lattice
// helpers, since removed from roi_align_common.cuh, are in namespace
// previous below.
//
// Multi-level aligned ROIAlign forward (7x7 output, sampling ratio 2) for
// NVIDIA Hopper (sm_90a), with a plain C interface loaded through ctypes by
// aldi_tpu_torch/ops/roi_align_kernel.py.
//
// Replaces the Pallas TPU kernel aldi_tpu/ops/pallas_roi_align.py:183
// (_roi_align_pallas_flat with _fine_kernel and _resident_kernel) and
// computes what it computes, the corner-gather semantics of
// aldi_tpu/ops/roi_align.py:61-121 (the sampling lattice is in
// roi_align_common.cuh). A box with level -1 (invalid) gives all zeros.
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

#include "roi_align_common.cuh"

namespace previous {

// Per axis (0 = y, box coords 1 and 3; 1 = x, box coords 0 and 2) and
// sample: the low and high corner index, the low-corner distance l (the
// weights are 1 - l and l) and whether the sample lies outside the level.
struct Lattice {
  int lo[2][roi_align::kMaxSamples];
  int hi[2][roi_align::kMaxSamples];
  float l[2][roi_align::kMaxSamples];
  bool oob[2][roi_align::kMaxSamples];
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

}  // namespace previous

namespace {

using roi_align::from_f32;
using roi_align::to_f32;

template <typename T>
__global__ void roi_align_fwd_kernel(roi_align::Levels<const void*> lv,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ levels,
                                     int boxes_per_image, int channels,
                                     int output_size, int sampling_ratio,
                                     T* __restrict__ out) {
  __shared__ previous::Lattice s;

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
  if (threadIdx.x < 2 * output_size * sampling_ratio)
    previous::sample_point(s, threadIdx.x, boxes + (size_t)n * 4,
                            lv.scale[lvl], H, W, output_size,
                            sampling_ratio);
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
          if (s.oob[0][iy]) continue;
          const float ly = s.l[0][iy];
          const float hy = __fsub_rn(1.f, ly);
          const size_t r0 = (size_t)s.lo[0][iy] * W;
          const size_t r1 = (size_t)s.hi[0][iy] * W;
          for (int sx = 0; sx < sampling_ratio; ++sx) {
            const int ix = ox * sampling_ratio + sx;
            if (s.oob[1][ix]) continue;
            const float lx = s.l[1][ix];
            const float hx = __fsub_rn(1.f, lx);
            const size_t x0 = s.lo[1][ix];
            const size_t x1 = s.hi[1][ix];
            const float v00 = to_f32(f[(r0 + x0) * channels]);
            const float v01 = to_f32(f[(r0 + x1) * channels]);
            const float v10 = to_f32(f[(r1 + x0) * channels]);
            const float v11 = to_f32(f[(r1 + x1) * channels]);
            float sum = __fmul_rn(v00, __fmul_rn(hy, hx));
            sum = __fadd_rn(sum, __fmul_rn(v01, __fmul_rn(hy, lx)));
            sum = __fadd_rn(sum, __fmul_rn(v10, __fmul_rn(ly, hx)));
            sum = __fadd_rn(sum, __fmul_rn(v11, __fmul_rn(ly, lx)));
            acc = __fadd_rn(acc, sum);
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
  if (roi_align::bad_args(num_levels, num_boxes, channels, boxes_per_image,
                          output_size, sampling_ratio, dtype))
    return (int)cudaErrorInvalidValue;
  const auto lv = roi_align::make_levels<const void*>(
      level_ptrs, level_hw, level_scale, num_levels);
  const int threads =
      previous::block_threads(channels, output_size, sampling_ratio);
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
