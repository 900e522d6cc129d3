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
// ~20 operations per byte at which an H100 stops being bound by memory, so
// the instructions it issues per byte matter as much as the bytes.
//
// Design: one warp per box, 4 boxes per block. The warp's lanes put the
// box's 2 x S lattice (row offsets, column indices, weights, out-of-range
// flags) in the warp's own slice of shared memory (no block-wide barrier),
// then walk the box's bins with the lanes across the channels: each lane
// loads 16 bytes of a corner row (8 bfloat16 or 4 float32 channels), so one
// warp instruction reads a whole 512-byte NHWC row of 256 bfloat16
// channels. A bin's 4 samples x 4 corners are all loaded before any sum
// (16 loads in flight per lane); a sample outside the level has clamped,
// in-range corners, is loaded like the others and is left out of the sum.
// The sum keeps the order of the plain version (sy, sx, then the corners
// 00, 01, 10, 11, each with __fmul_rn / __fadd_rn), so the kernel is
// bit-equal to it. Outputs are stored 16 bytes per lane. A channel count
// that is not a multiple of the vector width (or an unaligned level) takes
// the same kernel with one channel per lane: its rows are not 16-byte
// aligned. The TPU kernel's window DMAs, iota weight matrices and MXU
// products are TPU devices with no counterpart here.

#include "roi_align_common.cuh"

namespace {

using roi_align::channel;
using roi_align::load_raw;
using roi_align::Raw;
using roi_align::store_vec;

constexpr int kWarps = 4;  // boxes per block, one warp each

template <typename T, int N>
__global__ void __launch_bounds__(kWarps * 32)
    roi_align_fwd_kernel(roi_align::Levels<const void*> lv,
                         const float* __restrict__ boxes,
                         const int* __restrict__ levels, int boxes_per_image,
                         int num_boxes, int channels, int output_size,
                         int sampling_ratio, T* __restrict__ out) {
  // per warp and axis, per sample: (lo, hi, l bits, out of range); for y,
  // lo and hi are row offsets lo * W and hi * W
  __shared__ int4 lattice[kWarps][2][roi_align::kMaxSamples];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= num_boxes) return;
  const int lvl = levels[n];
  const int bins = output_size * output_size;
  const int nvec = channels / N;
  T* o = out + (size_t)n * bins * channels;
  if (lvl < 0) {
    const float zero[N] = {};
    for (int i = lane; i < bins * nvec; i += 32)
      store_vec<T, N>(o + (size_t)i * N, zero);
    return;
  }

  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  const int S = output_size * sampling_ratio;
  int4(*lat)[roi_align::kMaxSamples] = lattice[warp];
  for (int t = lane; t < 2 * S; t += 32) {
    const int axis = t / S;
    const int i = t - axis * S;
    const roi_align::Sample s =
        roi_align::sample_at(boxes + (size_t)n * 4, axis, i, lv.scale[lvl],
                             axis == 0 ? H : W, output_size, sampling_ratio);
    const int m = axis == 0 ? W : 1;
    lat[axis][i] = make_int4(s.lo * m, s.hi * m, __float_as_int(s.l), s.oob);
  }
  __syncwarp();

  const T* feat = static_cast<const T*>(lv.ptr[lvl]) +
                  (size_t)(n / boxes_per_image) * H * W * channels;
  const int count = sampling_ratio * sampling_ratio;
  const float inv_count = 1.f / (float)count;
  for (int v0 = 0; v0 < nvec; v0 += 32) {
    // lanes past the last vector load the last one again and store nothing
    const int v = min(v0 + lane, nvec - 1);
    const T* f = feat + (size_t)v * N;
    for (int bin = 0; bin < bins; ++bin) {
      const int oy = bin / output_size;
      const int ox = bin - oy * output_size;
      float acc[N];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = 0.f;
      // samples in groups of 4 (one group at sampling ratio 2)
      for (int s0 = 0; s0 < count; s0 += 4) {
        Raw<T, N> c[4][4];
        float w[4][4];
        bool ok[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = min(s0 + q, count - 1);
          const int sy = s / sampling_ratio;
          const int4 ey = lat[0][oy * sampling_ratio + sy];
          const int4 ex = lat[1][ox * sampling_ratio + s - sy * sampling_ratio];
          ok[q] = s0 + q < count && !ey.w && !ex.w;
          const float ly = __int_as_float(ey.z);
          const float lx = __int_as_float(ex.z);
          const float hy = __fsub_rn(1.f, ly);
          const float hx = __fsub_rn(1.f, lx);
          w[q][0] = __fmul_rn(hy, hx);
          w[q][1] = __fmul_rn(hy, lx);
          w[q][2] = __fmul_rn(ly, hx);
          w[q][3] = __fmul_rn(ly, lx);
          c[q][0] = load_raw<T, N>(f + (size_t)(ey.x + ex.x) * channels);
          c[q][1] = load_raw<T, N>(f + (size_t)(ey.x + ex.y) * channels);
          c[q][2] = load_raw<T, N>(f + (size_t)(ey.y + ex.x) * channels);
          c[q][3] = load_raw<T, N>(f + (size_t)(ey.y + ex.y) * channels);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!ok[q]) continue;  // the same for every lane of the warp
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float sum = __fmul_rn(channel<T, N>(c[q][0], e), w[q][0]);
            sum = __fadd_rn(sum, __fmul_rn(channel<T, N>(c[q][1], e), w[q][1]));
            sum = __fadd_rn(sum, __fmul_rn(channel<T, N>(c[q][2], e), w[q][2]));
            sum = __fadd_rn(sum, __fmul_rn(channel<T, N>(c[q][3], e), w[q][3]));
            acc[e] = __fadd_rn(acc[e], sum);
          }
        }
      }
      if (v0 + lane < nvec) {
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = __fmul_rn(acc[e], inv_count);
        store_vec<T, N>(o + (size_t)bin * channels + (size_t)v * N, acc);
      }
    }
  }
}

template <typename T>
void launch(const roi_align::Levels<const void*>& lv, const float* boxes,
            const int* levels, int boxes_per_image, int num_boxes,
            int channels, int output_size, int sampling_ratio, void* out,
            bool aligned, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int blocks = (num_boxes + kWarps - 1) / kWarps;
  if (aligned && channels % kVec == 0)
    roi_align_fwd_kernel<T, kVec><<<blocks, kWarps * 32, 0, s>>>(
        lv, boxes, levels, boxes_per_image, num_boxes, channels, output_size,
        sampling_ratio, static_cast<T*>(out));
  else
    roi_align_fwd_kernel<T, 1><<<blocks, kWarps * 32, 0, s>>>(
        lv, boxes, levels, boxes_per_image, num_boxes, channels, output_size,
        sampling_ratio, static_cast<T*>(out));
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
  const bool aligned = roi_align::levels_aligned(level_ptrs, num_levels) &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  if (dtype == 0)
    launch<float>(lv, b, lvl, boxes_per_image, num_boxes, channels,
                  output_size, sampling_ratio, out, aligned, s);
  else
    launch<__nv_bfloat16>(lv, b, lvl, boxes_per_image, num_boxes, channels,
                          output_size, sampling_ratio, out, aligned, s);
  return (int)cudaGetLastError();
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
