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
// batch: grid (anchor blocks, images), kThreads consecutive anchors per
// block, one per thread. Anchors are laid out [H*W, A] per level, so a
// block's anchors are a strip of one or two rows of one level, and only the
// gt boxes that meet that strip can give any of them an IoU above 0.
//
// Per-block gt culling. A block loads its anchors (16-byte loads), reduces
// their union box (min x0, min y0, max x1, max y1), and one thread per gt
// slot tests: valid, strictly overlapping the union box, and for K1b best
// > 0. The slots that pass are compacted into a shared-memory list in
// ascending slot order (a ballot per 32 slots, popcount prefixes). A slot
// that fails the test has intersection 0 with every anchor of the block
// (min(ax1, gx1) > max(ax0, gx0) for some anchor implies gx1 > min x0 and
// gx0 < max x1), so its IoU is exactly 0 there: it cannot change an
// anchor's argmax after the first valid slot, cannot raise its column's
// best above the 0 the buffer starts from, and cannot equal a best > 0.
// So K1a starts each anchor from (0, first valid slot), or (-1, 0) if the
// image has no valid slot, which is exactly where the dense walk stands
// after the slots the block skipped, and walks the list replacing only on a
// strictly greater IoU (the first-index argmax of torch.argmax). K1b walks
// its list (valid, overlapping, best > 0) and stops an anchor at its first
// hit.
//
// Bit-identity: K1b tests iou == best, so K1a, K1b and the plain PyTorch
// version (ops/boxes.py pairwise_iou) must round every IoU identically.
// iou_rn follows pairwise_iou's operation order with one rounding per
// operation (__f*_rn intrinsics: no fused multiply-add) and divides only
// where the intersection is positive (0 otherwise, as 0 / union is).
//
// The per-gt maximum across blocks: blocks run in no order, so each block
// reduces its anchors' IoUs per listed slot (a warp max, then a
// shared-memory atomic max) and then takes one global atomic max per listed
// slot. IoUs are >= 0, and non-negative floats order like their bit
// patterns read as unsigned integers, so the maxima are integer atomics on
// the float bits into a zeroed buffer; a valid slot no block lists keeps
// that 0, its dense best. Invalid columns are set to -1 by the wrapper.
//
// What bounds it on the card: bytes, once culled. Per image it reads each
// anchor once (16 B; the images' blocks re-read them from L2) and writes 8 B
// per anchor (K1a) or 1 B (K1b); the IoUs left are those of the pairs whose
// boxes meet a block's strip, about 10 per anchor at the flagship's
// synthetic gt where the dense walk took 70 (PERF.md gives the times
// against the bound). Where every gt box covers the canvas nothing is
// culled and the kernels do the dense walk's work plus the list. Two
// anchors per thread, a warp-level second cull and other block orders
// measured no better (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGt = 256;  // gt slots per image; the wrapper raises above
constexpr int kThreads = 256;  // one anchor, and one gt slot, per thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned int kFull = 0xffffffffu;
static_assert(kThreads == kMaxGt, "build_list tests one slot per thread");

__device__ __forceinline__ float area_rn(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// pairwise_iou of one anchor and one gt box, in its operation order:
// wh = clamp(min(rb) - max(lt), 0); inter = w*h; union = (a1 + a2) - inter;
// iou = union > 0 ? inter / union : 0 (and 0 without intersection)
__device__ __forceinline__ float iou_rn(float4 a, float area_a, float4 g,
                                        float area_g) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, g.z), fmaxf(a.x, g.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, g.w), fmaxf(a.y, g.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_g), inter);
  return inter > 0.f && uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// One block's candidate list, in ascending slot order, and the scratch
// that builds it.
struct Candidates {
  float4 box[kMaxGt];
  float area[kMaxGt];
  int slot[kMaxGt];
  float best[kMaxGt];         // K1b: the slot's best IoU
  unsigned int top[kMaxGt];   // K1a: the block's best IoU, float bits
  float4 extent[kWarps];      // per-warp union boxes of the anchors
  int count[kWarps];          // listed slots per warp's 32 slots
  int first_valid[kWarps];    // lowest valid slot per warp, or kMaxGt
};

// Loads anchor i (if ``in``: it exists) and stores the union box of its
// warp's anchors in s.extent.
__device__ __forceinline__ float4 load_anchor(
    const float4* __restrict__ anchors, int i, bool in, Candidates& s) {
  const float4 a = in ? anchors[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 e = in ? a : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    e.x = fminf(e.x, __shfl_xor_sync(kFull, e.x, o));
    e.y = fminf(e.y, __shfl_xor_sync(kFull, e.y, o));
    e.z = fmaxf(e.z, __shfl_xor_sync(kFull, e.z, o));
    e.w = fmaxf(e.w, __shfl_xor_sync(kFull, e.w, o));
  }
  if ((threadIdx.x & 31) == 0) s.extent[threadIdx.x >> 5] = e;
  return a;
}

// After load_anchor and a __syncthreads: compacts image b's slots that are
// valid, strictly overlap the block's union box and (kLowQ) have best > 0
// into s, in ascending slot order (thread j tests slot j). Returns (listed
// count, lowest valid slot or -1). Every thread of the block calls it; it
// synchronizes twice.
template <bool kLowQ>
__device__ __forceinline__ int2 build_list(const float* __restrict__ gt,
                                           const uint8_t* __restrict__ valid,
                                           const float* __restrict__ best,
                                           int b, int m, Candidates& s) {
  float4 e = s.extent[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    e.x = fminf(e.x, s.extent[w].x);
    e.y = fminf(e.y, s.extent[w].y);
    e.z = fmaxf(e.z, s.extent[w].z);
    e.w = fmaxf(e.w, s.extent[w].w);
  }
  const int j = threadIdx.x, warp = j >> 5, lane = j & 31;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  float g_best = 0.f;
  bool ok = false, pass = false;
  if (j < m) {
    const size_t o = (size_t)b * m + j;
    const float* p = gt + o * 4;
    g = make_float4(p[0], p[1], p[2], p[3]);
    ok = valid[o] != 0;
    if (kLowQ) g_best = best[o];
    pass = ok && g.z > e.x && g.x < e.z && g.w > e.y && g.y < e.w &&
           (!kLowQ || g_best > 0.f);
  }
  const unsigned int oks = __ballot_sync(kFull, ok);
  const unsigned int passed = __ballot_sync(kFull, pass);
  if (lane == 0) {
    s.count[warp] = __popc(passed);
    s.first_valid[warp] = oks ? warp * 32 + __ffs(oks) - 1 : kMaxGt;
  }
  __syncthreads();
  int total = 0, first_valid = kMaxGt;
  int pos = __popc(passed & ((1u << lane) - 1u));
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pos += s.count[w];
    total += s.count[w];
    first_valid = min(first_valid, s.first_valid[w]);
  }
  if (pass) {
    s.box[pos] = g;
    s.area[pos] = area_rn(g);
    s.slot[pos] = j;
    s.best[pos] = g_best;
    s.top[pos] = 0u;
  }
  __syncthreads();
  return make_int2(total, first_valid < kMaxGt ? first_valid : -1);
}

// grid (anchor blocks, images): block (x, b) takes anchors x * kThreads ...
// of image b.
__global__ void __launch_bounds__(kThreads)
    match_iou_kernel(const float4* __restrict__ anchors, int n,
                     const float* __restrict__ gt,
                     const uint8_t* __restrict__ valid, int m,
                     float* __restrict__ vals, int* __restrict__ idx,
                     unsigned int* __restrict__ best_bits) {
  __shared__ Candidates s;
  const int b = blockIdx.y, i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const float4 a = load_anchor(anchors, i, in, s);
  __syncthreads();
  const int2 list = build_list<false>(gt, valid, nullptr, b, m, s);

  const float area_a = area_rn(a);
  float best = list.y >= 0 ? 0.f : -1.f;
  int arg = max(list.y, 0);
  for (int c = 0; c < list.x; ++c) {  // the same list for the whole block
    const float v = iou_rn(a, area_a, s.box[c], s.area[c]);
    if (v > best) {
      best = v;
      arg = s.slot[c];
    }
    const unsigned int r =
        __reduce_max_sync(kFull, in ? __float_as_uint(v) : 0u);
    if ((threadIdx.x & 31) == 0 && r) atomicMax(&s.top[c], r);
  }
  if (in) {
    vals[(size_t)b * n + i] = best;
    idx[(size_t)b * n + i] = arg;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < list.x; c += kThreads)
    if (s.top[c]) atomicMax(&best_bits[(size_t)b * m + s.slot[c]], s.top[c]);
}

__global__ void __launch_bounds__(kThreads)
    low_quality_kernel(const float4* __restrict__ anchors, int n,
                       const float* __restrict__ gt,
                       const uint8_t* __restrict__ valid, int m,
                       const float* __restrict__ best,
                       uint8_t* __restrict__ mask) {
  __shared__ Candidates s;
  const int b = blockIdx.y, i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const float4 a = load_anchor(anchors, i, in, s);
  __syncthreads();
  const int2 list = build_list<true>(gt, valid, best, b, m, s);

  const float area_a = area_rn(a);
  bool hit = false;
  for (int c = 0; c < list.x && !hit; ++c)  // stop at the first hit
    hit = iou_rn(a, area_a, s.box[c], s.area[c]) == s.best[c];
  if (in) mask[(size_t)b * n + i] = hit;
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
