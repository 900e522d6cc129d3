// The previous ROIAlign backward kernel (one block per box, float32
// atomics into zeroed level tables), kept for
// aldi_tpu_torch/tools/kernel_variants.py to time beside the current
// source in one process. Built with -I aldi_tpu_torch/csrc; its lattice
// helpers, since removed from roi_align_common.cuh, are in namespace
// previous below. Its entry point is renamed
// aldi_roi_align_bwd_tables: it takes zeroed float32 tables, which the
// tool allocates and casts as the previous wrapper did.
//
// Multi-level aligned ROIAlign backward with respect to the features, for
// NVIDIA Hopper (sm_90a), with a plain C interface loaded through ctypes by
// aldi_tpu_torch/ops/roi_align_kernel.py.
//
// Replaces the XLA scatter-add backward of the JAX package's ROIAlign,
// aldi_tpu/ops/roi_align.py:342 _fused_bwd (batched at :426; in JAX it is
// not a Pallas kernel): the forward is linear in the features, so
// d(features) is, per sample that reads features, the bin's cotangent
// g/(sr*sr) times each bilinear corner weight, added into that corner's
// feature row; d(boxes) is zero (proposal boxes are constants of the ROI
// stage). The sampling lattice is the forward kernel's
// (roi_align_common.cuh), so every weight is bit-identical to the forward's
// and to the plain PyTorch version's.
//
// Design: one block per box over the flattened B*P boxes, the box's lattice
// in shared memory, threads across channels; each thread adds its channel's
// 49 bins x 4 samples x 4 corner contributions with atomicAdd into a zeroed
// float32 gradient table per level ([B, H_l, W_l, C], NHWC), so a warp's
// atomics hit 32 neighbouring addresses. The wrapper casts the table to the
// features' dtype afterwards (float32 accumulation, as _fused_bwd). Atomics
// add in a different order on every run, so float32 results differ from
// run to run in the last bits.
//
// What bounds it on the card: the bytes it moves. It reads the cotangent
// once (B*P*49*C values) and writes the dense per-level gradient (every
// feature element of every level, zeros included); per sample and channel
// it does 4 products and 4 additions.

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

using roi_align::to_f32;

template <typename T>
__global__ void roi_align_bwd_kernel(roi_align::Levels<float*> lv,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ levels,
                                     int boxes_per_image, int channels,
                                     int output_size, int sampling_ratio,
                                     const T* __restrict__ grad) {
  __shared__ previous::Lattice s;

  const int n = blockIdx.x;
  const int lvl = levels[n];
  if (lvl < 0) return;  // an invalid box read no features
  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  if (threadIdx.x < 2 * output_size * sampling_ratio)
    previous::sample_point(s, threadIdx.x, boxes + (size_t)n * 4,
                            lv.scale[lvl], H, W, output_size,
                            sampling_ratio);
  __syncthreads();

  float* table =
      lv.ptr[lvl] + (size_t)(n / boxes_per_image) * H * W * channels;
  const T* g = grad + (size_t)n * output_size * output_size * channels;
  const float count = (float)(sampling_ratio * sampling_ratio);
  for (int ch = threadIdx.x; ch < channels; ch += blockDim.x) {
    float* t = table + ch;
    for (int oy = 0; oy < output_size; ++oy) {
      for (int ox = 0; ox < output_size; ++ox) {
        // each of the sr*sr samples of the bin receives g / (sr*sr)
        const float gs = __fdiv_rn(
            to_f32(g[(oy * output_size + ox) * channels + ch]), count);
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
            atomicAdd(t + (r0 + x0) * channels,
                      __fmul_rn(gs, __fmul_rn(hy, hx)));
            atomicAdd(t + (r0 + x1) * channels,
                      __fmul_rn(gs, __fmul_rn(hy, lx)));
            atomicAdd(t + (r1 + x0) * channels,
                      __fmul_rn(gs, __fmul_rn(ly, hx)));
            atomicAdd(t + (r1 + x1) * channels,
                      __fmul_rn(gs, __fmul_rn(ly, lx)));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// grad_dtype: 0 = float32, 1 = bfloat16 (the cotangent's dtype). level_ptrs
// is a host array of num_levels device pointers to ZEROED float32 gradient
// tables [B, H_l, W_l, channels], level_hw a host array of (H, W) pairs,
// level_scale a host array of 1/stride. boxes [num_boxes, 4] f32, levels
// [num_boxes] int32 and grad [num_boxes, output_size, output_size,
// channels] are on the device; box n belongs to image n / boxes_per_image.
// Returns cudaGetLastError() after the launch.
int aldi_roi_align_bwd_tables(const void* level_ptrs, const void* level_hw,
                       const void* level_scale, int num_levels,
                       const void* boxes, const void* levels,
                       int boxes_per_image, int num_boxes, int channels,
                       int output_size, int sampling_ratio, int grad_dtype,
                       const void* grad, void* stream) {
  if (roi_align::bad_args(num_levels, num_boxes, channels, boxes_per_image,
                          output_size, sampling_ratio, grad_dtype))
    return (int)cudaErrorInvalidValue;
  const auto lv = roi_align::make_levels<float*>(level_ptrs, level_hw,
                                                 level_scale, num_levels);
  const int threads =
      previous::block_threads(channels, output_size, sampling_ratio);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  if (grad_dtype == 0)
    roi_align_bwd_kernel<float><<<num_boxes, threads, 0, s>>>(
        lv, b, lvl, boxes_per_image, channels, output_size, sampling_ratio,
        static_cast<const float*>(grad));
  else
    roi_align_bwd_kernel<__nv_bfloat16><<<num_boxes, threads, 0, s>>>(
        lv, b, lvl, boxes_per_image, channels, output_size, sampling_ratio,
        static_cast<const __nv_bfloat16*>(grad));
  return (int)cudaGetLastError();
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
