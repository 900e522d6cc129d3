// Anchor <-> ground-truth IoU matching (RPN Matcher) for NVIDIA Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// aldi_tpu_torch/ops/match_kernel.py. Two kernels in one source:
//
//   K1a match_iou_kernel replaces the Pallas TPU kernel
//       aldi_tpu/ops/pallas_match.py:67 match_iou_pallas (_kernel, _tile_iou):
//       per anchor, the best IoU over the valid gt boxes and its argmax (the
//       first index on ties; an invalid gt column scores -1), and per gt box
//       the best IoU over all anchors.
//   K1b low_quality_kernel replaces aldi_tpu/ops/pallas_match.py:139
//       low_quality_mask_pallas (_lowq_kernel): the anchors whose IoU with a
//       valid gt box EQUALS that box's best (> 0).
//
// Neither materializes the [N, M] IoU matrix. One launch covers the whole
// batch: grid (anchor blocks, images); each block puts its image's M gt
// boxes, flags and areas in shared memory and each thread takes one anchor,
// walking the gt boxes in ascending order and replacing its best only on a
// strictly greater IoU (the first-index argmax of jnp.argmax/torch.argmax).
//
// Bit-identity: K1b tests iou == best, so K1a, K1b and the plain PyTorch
// version (ops/boxes.py pairwise_iou) must round every IoU identically. Both
// kernels call iou_rn, which follows pairwise_iou's operation order with one
// rounding per operation (__f*_rn intrinsics: no fused multiply-add).
//
// The per-gt maximum across blocks: blocks run in no order, so each block
// reduces its anchors' IoUs per gt box (a warp max, then a shared-memory
// atomic max) and then takes one global atomic max per gt box. A valid
// column's IoUs are >= 0, and non-negative floats order like their bit
// patterns read as unsigned integers, so the maxima are integer atomics on
// the float bits into a zeroed buffer. Invalid columns (-1) are skipped
// here and set to -1 by the wrapper.
//
// What bounds it on the card: operations. Per image it reads each anchor
// once (16 B) and writes 8 B per anchor (K1a) or 1 B (K1b), but it computes
// N*M IoUs of about 12 float operations each: at the flagship's N = 523,776
// anchors and M = 100 gt slots that is 0.63 GFLOP per image against 13 MB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxGt = 256;  // gt slots per image; the wrapper raises above
constexpr int kThreads = 256;

__device__ __forceinline__ float area_rn(float x0, float y0, float x1,
                                         float y1) {
  return __fmul_rn(__fsub_rn(x1, x0), __fsub_rn(y1, y0));
}

// pairwise_iou of one anchor and one gt box, in its operation order:
// wh = clamp(min(rb) - max(lt), 0); inter = w*h; union = (a1 + a2) - inter;
// iou = union > 0 ? inter / union : 0
__device__ __forceinline__ float iou_rn(float4 a, float area_a, float gx0,
                                        float gy0, float gx1, float gy1,
                                        float area_g) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, gx1), fmaxf(a.x, gx0)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, gy1), fmaxf(a.y, gy0)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

struct GtTile {
  float x0[kMaxGt], y0[kMaxGt], x1[kMaxGt], y1[kMaxGt], area[kMaxGt];
  bool valid[kMaxGt];
};

__device__ void load_gt(GtTile& t, const float* gt, const uint8_t* valid,
                        int b, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float* g = gt + ((size_t)b * m + j) * 4;
    t.x0[j] = g[0];
    t.y0[j] = g[1];
    t.x1[j] = g[2];
    t.y1[j] = g[3];
    t.area[j] = area_rn(g[0], g[1], g[2], g[3]);
    t.valid[j] = valid[(size_t)b * m + j] != 0;
  }
}

__global__ void match_iou_kernel(const float4* __restrict__ anchors, int n,
                                 const float* __restrict__ gt,
                                 const uint8_t* __restrict__ valid, int m,
                                 float* __restrict__ vals,
                                 int* __restrict__ idx,
                                 unsigned int* __restrict__ best_bits) {
  __shared__ GtTile t;
  __shared__ unsigned int s_best[kMaxGt];
  const int b = blockIdx.y;
  load_gt(t, gt, valid, b, m);
  for (int j = threadIdx.x; j < m; j += blockDim.x) s_best[j] = 0u;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const float4 a = in ? anchors[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float area_a = area_rn(a.x, a.y, a.z, a.w);
  float best = -1.f;
  int arg = 0;
  for (int j = 0; j < m; ++j) {
    float v = -1.f;
    if (t.valid[j]) {  // the same for the whole block: every lane reduces
      v = iou_rn(a, area_a, t.x0[j], t.y0[j], t.x1[j], t.y1[j], t.area[j]);
      const unsigned int r =
          __reduce_max_sync(0xffffffffu, in ? __float_as_uint(v) : 0u);
      if ((threadIdx.x & 31) == 0) atomicMax(&s_best[j], r);
    }
    if (j == 0 || v > best) {
      best = v;
      arg = j;
    }
  }
  if (in) {
    vals[(size_t)b * n + i] = best;
    idx[(size_t)b * n + i] = arg;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    if (t.valid[j]) atomicMax(&best_bits[(size_t)b * m + j], s_best[j]);
}

__global__ void low_quality_kernel(const float4* __restrict__ anchors, int n,
                                   const float* __restrict__ gt,
                                   const uint8_t* __restrict__ valid, int m,
                                   const float* __restrict__ best,
                                   uint8_t* __restrict__ mask) {
  __shared__ GtTile t;
  __shared__ float s_best[kMaxGt];
  const int b = blockIdx.y;
  load_gt(t, gt, valid, b, m);
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    s_best[j] = best[(size_t)b * m + j];
    t.valid[j] = t.valid[j] && s_best[j] > 0.f;  // only these can mark
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 a = anchors[i];
  const float area_a = area_rn(a.x, a.y, a.z, a.w);
  bool hit = false;
  for (int j = 0; j < m; ++j) {
    if (!t.valid[j]) continue;
    hit |= iou_rn(a, area_a, t.x0[j], t.y0[j], t.x1[j], t.y1[j],
                  t.area[j]) == s_best[j];
  }
  mask[(size_t)b * n + i] = hit ? 1 : 0;
}

bool bad_shape(int n, int m, int batch) {
  return n < 1 || m < 1 || m > kMaxGt || batch < 1 || batch > 65535;
}

}  // namespace

extern "C" {

int aldi_match_max_gt() { return kMaxGt; }

// anchors [n, 4] f32 (16-byte aligned), gt [batch, m, 4] f32, valid
// [batch, m] bool, all on the device. Writes vals [batch, n] f32, idx
// [batch, n] int32 and, by atomic max into a ZEROED buffer, best_bits
// [batch, m] (the float bits of each valid column's best IoU). Returns
// cudaGetLastError() after the launch.
int aldi_match_iou(const void* anchors, int n, const void* gt,
                   const void* valid, int m, int batch, void* vals, void* idx,
                   void* best_bits, void* stream) {
  if (bad_shape(n, m, batch)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  match_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(anchors), n, static_cast<const float*>(gt),
      static_cast<const uint8_t*>(valid), m, static_cast<float*>(vals),
      static_cast<int*>(idx), static_cast<unsigned int*>(best_bits));
  return (int)cudaGetLastError();
}

// As above, plus best [batch, m] f32 from aldi_match_iou; writes mask
// [batch, n] (one byte 0/1 per anchor).
int aldi_low_quality_mask(const void* anchors, int n, const void* gt,
                          const void* valid, const void* best, int m,
                          int batch, void* mask, void* stream) {
  if (bad_shape(n, m, batch)) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  low_quality_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(anchors), n, static_cast<const float*>(gt),
      static_cast<const uint8_t*>(valid), m, static_cast<const float*>(best),
      static_cast<uint8_t*>(mask));
  return (int)cudaGetLastError();
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
