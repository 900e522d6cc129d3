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
// What bounds it on the card: the bytes it moves. It must write the dense
// per-level gradient once (every feature element of every level, zeros
// included: 357 MB in bfloat16 at a training step's 4 images of p2..p5 of
// 1024x2048 with 256 channels) and read the cotangent once; per sample and
// channel it does 4 products and 4 additions.
//
// Design: tile-owned accumulation, no float32 table in device memory and no
// atomics on the gradient. Two kernels on the caller's stream:
//   1. roi_bins: one block per (image, level) walks the image's boxes in
//      order. For each box of its level it computes the pixel rectangle
//      the box's in-range samples' corners can touch (the min of lo and
//      the max of hi per axis, so a degenerate box whose lattice runs
//      backwards is covered too), appends (box, rectangle) to the level's
//      list in box order (a ballot and a prefix count) and flags every
//      tile the rectangle meets.
//   2. roi_tiles: one block per kTileH x kTileW pixel tile of one (image,
//      level) and per chunk of at most 256 channels, the coarsest level's
//      tiles first (they list the most boxes). An unflagged tile writes
//      zeros and is done. A flagged one keeps, from its level's list, the
//      boxes whose rectangle meets it, in box order, with their coordinates
//      in shared memory; stages their lattices 8 boxes at a time; and walks
//      their bins that have a sample corner in the tile. Per bin it loads
//      the cotangent once (4 bins' loads in flight per thread, the next 4
//      issued before this 4's adds) and adds, for each such sample
//      and corner, __fmul_rn(g / (sr*sr), corner weight) into a float32
//      accumulator in shared memory (8 x 8 x 256 x 4 B = 64 KB). Each of
//      the block's 4 warps owns every fourth row of the tile, each lane 8
//      channels of those rows' pixels (one 16-byte cotangent load per bin,
//      16-byte shared-memory adds), so the adds need no atomics and run in
//      a fixed (box, bin y, bin x, sample y, sample x, corner) order: the
//      result is the same on every run. The block
//      then writes its tile once in the features' dtype, 16 bytes per
//      store.
// On an H100 it reaches a fifth to a quarter of the byte bound. Per-block
// timing (aldi_tpu_torch/tools/roi_tile_timing.py) puts the time in the
// adds of the tiles that many boxes meet (the coarse levels' tiles, dense
// clusters of boxes), not in the binning, the lattices or the loads; the
// 64 KB accumulator and up to 168 registers leave three blocks of four
// warps per SM.
// The bfloat16 result is one rounding of a float32 sum, as _fused_bwd
// gives. A channel count that is not a multiple of 8 (or an unaligned
// pointer) takes the same kernel with one channel per lane, 32-channel
// chunks and scalar stores.

#include <limits.h>

#include "roi_align_common.cuh"

namespace {

using roi_align::store_vec;

constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kRound = 256;      // list entries binned per round
constexpr int kLatBoxes = 8;     // boxes whose lattices are staged at once
constexpr int kWarps = 4;        // per tile block
constexpr int kBatch = 4;        // cotangent loads in flight per thread
constexpr int kBinThreads = 256;

// The tile blocks of level l are [start[l], start[l] + images * tiles[l]),
// image by image, tiles_x[l] tiles per tile row; the coarsest level first.
struct TileMap {
  int start[roi_align::kMaxLevels];
  int tiles[roi_align::kMaxLevels];
  int tiles_x[roi_align::kMaxLevels];
  int num_levels;
  int blocks;
};

inline TileMap make_tile_map(const int32_t* hw, int num_levels, int images) {
  TileMap tm;
  tm.num_levels = num_levels;
  tm.blocks = 0;
  for (int l = num_levels - 1; l >= 0; --l) {
    tm.tiles_x[l] = (hw[2 * l + 1] + kTileW - 1) / kTileW;
    tm.tiles[l] = (hw[2 * l] + kTileH - 1) / kTileH * tm.tiles_x[l];
    tm.start[l] = tm.blocks;
    tm.blocks += images * tm.tiles[l];
  }
  return tm;
}

// Device scratch, carved from one buffer: per (image, level) the rectangles
// and box indices of its boxes in order, and their count; a flag per tile.
struct Scratch {
  int4* level_rect;  // [images * L * P]
  int* level_box;    // [images * L * P]
  int* level_n;      // [images * L]
  int* tile_flag;    // [tm.blocks]
};

inline size_t scratch_bytes(const TileMap& tm, int images, int num_boxes) {
  return (size_t)num_boxes * tm.num_levels * (sizeof(int4) + sizeof(int)) +
         (size_t)(images * tm.num_levels + tm.blocks) * sizeof(int);
}

inline Scratch carve(void* base, const TileMap& tm, int images,
                     int num_boxes) {
  Scratch sc;
  const size_t entries = (size_t)num_boxes * tm.num_levels;
  sc.level_rect = static_cast<int4*>(base);
  sc.level_box = reinterpret_cast<int*>(sc.level_rect + entries);
  sc.level_n = sc.level_box + entries;
  sc.tile_flag = sc.level_n + images * tm.num_levels;
  return sc;
}

__global__ void __launch_bounds__(kBinThreads)
    roi_bins_kernel(roi_align::Levels<void*> lv, TileMap tm,
                    const float* __restrict__ boxes,
                    const int* __restrict__ levels, int boxes_per_image,
                    int output_size, int sampling_ratio, Scratch sc) {
  __shared__ int warp_sum[kBinThreads / 32];
  const int img = blockIdx.x / tm.num_levels;
  const int lvl = blockIdx.x - img * tm.num_levels;
  const int S = output_size * sampling_ratio;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t list = (size_t)blockIdx.x * boxes_per_image;
  int n = 0;  // entries so far, the same in every thread
  for (int start = 0; start < boxes_per_image; start += kBinThreads) {
    const int i = start + threadIdx.x;
    const int box = img * boxes_per_image + i;
    int4 r = make_int4(INT_MAX, -1, INT_MAX, -1);
    if (i < boxes_per_image && levels[box] == lvl) {
      int lo_y = INT_MAX, hi_y = -1, lo_x = INT_MAX, hi_x = -1;
      for (int s = 0; s < S; ++s) {
        const roi_align::Sample y =
            roi_align::sample_at(boxes + (size_t)box * 4, 0, s, lv.scale[lvl],
                                 lv.h[lvl], output_size, sampling_ratio);
        if (!y.oob) {
          lo_y = min(lo_y, y.lo);
          hi_y = max(hi_y, y.hi);
        }
        const roi_align::Sample x =
            roi_align::sample_at(boxes + (size_t)box * 4, 1, s, lv.scale[lvl],
                                 lv.w[lvl], output_size, sampling_ratio);
        if (!x.oob) {
          lo_x = min(lo_x, x.lo);
          hi_x = max(hi_x, x.hi);
        }
      }
      if (hi_y >= 0 && hi_x >= 0) r = make_int4(lo_y, hi_y, lo_x, hi_x);
    }
    const bool keep = r.y >= 0;
    if (keep) {  // flag the tiles the rectangle meets
      int* flag = sc.tile_flag + tm.start[lvl] + img * tm.tiles[lvl];
      for (int ty = r.x / kTileH; ty <= r.y / kTileH; ++ty)
        for (int tx = r.z / kTileW; tx <= r.w / kTileW; ++tx)
          flag[ty * tm.tiles_x[lvl] + tx] = 1;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_sum[warp] = __popc(bal);
    __syncthreads();
    int pos = n + __popc(bal & ((1u << lane) - 1));
    for (int w = 0; w < kBinThreads / 32; ++w) {
      pos += w < warp ? warp_sum[w] : 0;
      n += warp_sum[w];
    }
    if (keep) {
      sc.level_rect[list + pos] = r;
      sc.level_box[list + pos] = i;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) sc.level_n[blockIdx.x] = n;
}

// CPT channels of the cotangent as loaded: 16-byte vectors (CPT = 8), or
// one scalar (CPT = 1).
template <typename TG, int CPT>
struct GradVec {
  static constexpr int kV = CPT == 1 ? 1 : 16 / (int)sizeof(TG);
  roi_align::Raw<TG, kV> r[CPT / kV];

  __device__ __forceinline__ void load(const TG* g) {
#pragma unroll
    for (int k = 0; k < CPT / kV; ++k) r[k] = roi_align::load_raw<TG, kV>(g + k * kV);
  }
  __device__ __forceinline__ float operator[](int i) const {
    return roi_align::channel<TG, kV>(r[i / kV], i % kV);
  }
};

// acc[0 .. CPT) += g * w, in shared memory, 16 bytes at a time for CPT 8.
// acc[0 .. CPT) += g * w, in shared memory, 16 bytes at a time for CPT 8.
template <int CPT>
__device__ __forceinline__ void add_term(float* a, const float (&g)[CPT],
                                         float w) {
  if constexpr (CPT == 1) {
    a[0] = __fadd_rn(a[0], __fmul_rn(g[0], w));
  } else {
    float4* a4 = reinterpret_cast<float4*>(a);
#pragma unroll
    for (int k = 0; k < CPT / 4; ++k) {
      float4 v = a4[k];
      v.x = __fadd_rn(v.x, __fmul_rn(g[4 * k], w));
      v.y = __fadd_rn(v.y, __fmul_rn(g[4 * k + 1], w));
      v.z = __fadd_rn(v.z, __fmul_rn(g[4 * k + 2], w));
      v.w = __fadd_rn(v.w, __fmul_rn(g[4 * k + 3], w));
      a4[k] = v;
    }
  }
}

// kWarps warps; warp w owns the tile rows r with r % kWarps == w, and its
// lane l the channels l * CPT .. l * CPT + CPT - 1 of the chunk (CPT 8 on
// the vector path: one 16-byte cotangent load per bin and 16-byte
// shared-memory adds; chunk <= 32 * CPT). VS channels per store (16 bytes
// on the vector path).
template <typename TG, typename TF, int CPT, int VS>
__global__ void __launch_bounds__(kWarps * 32, 3)  // 3 blocks of 64 KB per SM
    roi_tiles_kernel(roi_align::Levels<void*> lv, TileMap tm,
                     const float* __restrict__ boxes, Scratch sc,
                     int boxes_per_image, int channels, int chunk,
                     int output_size, int sampling_ratio,
                     const TG* __restrict__ grad) {
  const int S = output_size * sampling_ratio;
  // acc: [kTileH * kTileW][chunk] float32; lat: per staged box and axis,
  // per sample (lo - tile origin, hi - tile origin, l bits, bit 0: lo in
  // the tile, bit 1: hi in the tile; 0 outside the level); picks: per
  // staged box and axis, the bins with a sample corner in the tile, in
  // order, as bin | (mask of those samples) << 16
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);
  int4* lat = reinterpret_cast<int4*>(acc + kTileH * kTileW * chunk);
  int* picks = reinterpret_cast<int*>(lat + kLatBoxes * 2 * S);
  __shared__ int list[kRound];         // the boxes meeting the tile
  __shared__ float4 list_box[kRound];  // and their coordinates
  __shared__ int warp_sum[kWarps];
  __shared__ int n_picks[kLatBoxes * 2];

  int lvl = 0;
  for (int l = 1; l < tm.num_levels; ++l)
    if (blockIdx.x >= tm.start[l] && blockIdx.x < tm.start[lvl]) lvl = l;
  const int img = (blockIdx.x - tm.start[lvl]) / tm.tiles[lvl];
  const int t = blockIdx.x - tm.start[lvl] - img * tm.tiles[lvl];
  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  const int y0 = (t / tm.tiles_x[lvl]) * kTileH;
  const int x0 = (t % tm.tiles_x[lvl]) * kTileW;
  const int th = min(kTileH, H - y0);
  const int tw = min(kTileW, W - x0);
  const int c0 = blockIdx.y * chunk;
  const int cc = min(chunk, channels - c0);
  const int bins = output_size * output_size;
  // g / (sr*sr): a product with the reciprocal where sr*sr is a power of
  // two (the same value, fewer instructions), else a true division
  const int n_samples = sampling_ratio * sampling_ratio;
  const float count = (float)n_samples;
  const bool exact_inverse = (n_samples & (n_samples - 1)) == 0;
  const float inv_count = 1.f / count;
  const int first = img * boxes_per_image;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = lane * CPT;  // this thread's channels c .. c + CPT - 1
  const bool active = c < cc;

  // the same in every thread: no box meets an unflagged tile
  const bool touched = sc.tile_flag[blockIdx.x] != 0;
  const size_t entries = (size_t)(img * tm.num_levels + lvl) * boxes_per_image;
  const int level_n = sc.level_n[img * tm.num_levels + lvl];  // load at once
  const int n_level = touched ? level_n : 0;
  if (touched) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = tid; k < kTileH * kTileW * chunk / 4; k += blockDim.x)
      smem[k] = z;
  }
  for (int start = 0; start < n_level; start += kRound) {
    // the boxes of the level's list whose rectangle meets the tile, in box
    // order; each thread checks `per` consecutive entries, all loads issued
    // before any test
    const int end = min(start + kRound, n_level);
    const int per = (end - start + blockDim.x - 1) / blockDim.x;  // <= 2
    const int mine = start + tid * per;
    unsigned hits = 0;
    int box8[8];
    for (int j0 = 0; j0 < per; j0 += 8) {
      int4 r8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = j0 + j < per && mine + j0 + j < end;
        r8[j] = in ? sc.level_rect[entries + mine + j0 + j]
                   : make_int4(INT_MAX, -1, INT_MAX, -1);
        if (j0 == 0) box8[j] = in ? sc.level_box[entries + mine + j] : 0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (r8[j].x < y0 + th && r8[j].y >= y0 && r8[j].z < x0 + tw &&
            r8[j].w >= x0)
          hits |= 1u << (j0 + j);
    }
    const int mine_hits = __popc(hits);
    int incl = mine_hits;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int pos = incl - mine_hits, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    for (unsigned m = hits; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int box = j < 8 ? box8[j] : sc.level_box[entries + mine + j];
      list[pos] = box;
      list_box[pos++] =
          *reinterpret_cast<const float4*>(boxes + (size_t)(first + box) * 4);
    }
    __syncthreads();

    for (int b0 = 0; b0 < total; b0 += kLatBoxes) {
      const int nb = min(kLatBoxes, total - b0);
      // stage the lattices of the next nb boxes, relative to the tile
      for (int e = tid; e < nb * 2 * S; e += blockDim.x) {
        const int axis = (e / S) & 1;
        const roi_align::Sample p = roi_align::sample_at(
            reinterpret_cast<const float*>(&list_box[b0 + e / (2 * S)]),
            axis, e % S, lv.scale[lvl], axis == 0 ? H : W, output_size,
            sampling_ratio);
        const int origin = axis == 0 ? y0 : x0;
        const unsigned extent = axis == 0 ? th : tw;
        const int lo = p.lo - origin;
        const int hi = p.hi - origin;
        const int in = p.oob ? 0
                             : ((unsigned)lo < extent) |
                                   (((unsigned)hi < extent) << 1);
        lat[e] = make_int4(lo, hi, __float_as_int(p.l), in);
      }
      __syncthreads();
      // per box and axis, the bins with a sample corner in the tile
      for (int qa = warp; qa < nb * 2; qa += kWarps) {
        int n = 0;
        for (int o0 = 0; o0 < output_size; o0 += 32) {
          const int o = o0 + lane;
          int mask = 0;
          for (int s = 0; s < sampling_ratio && o < output_size; ++s)
            mask |= (lat[qa * S + o * sampling_ratio + s].w != 0) << s;
          const unsigned bal = __ballot_sync(0xffffffffu, mask != 0);
          if (mask) picks[qa * S + n + __popc(bal & ((1u << lane) - 1))] =
              o | mask << 16;
          n += __popc(bal);
        }
        if (lane == 0) n_picks[qa] = n;
      }
      __syncthreads();
      if (active) {
        // the (box, bin y, bin x) pairs of the staged boxes, in order:
        // pairs of box q are [pre[q], pre[q + 1])
        int pre[kLatBoxes + 1];
        pre[0] = 0;
#pragma unroll
        for (int q = 0; q < kLatBoxes; ++q)
          pre[q + 1] = pre[q] + (q < nb ? n_picks[2 * q] * n_picks[2 * q + 1]
                                        : 0);
        const int n_pairs = pre[kLatBoxes];
        // kBatch bins' cotangent loads in flight before any add, the next
        // batch's issued before this batch's adds
        GradVec<TG, CPT> gv[kBatch], gv_next[kBatch];
        int by[kBatch], bx[kBatch], qs[kBatch];
        int by_next[kBatch], bx_next[kBatch], qs_next[kBatch];
        auto fetch = [&](int e0) {
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int e = min(e0 + j, n_pairs - 1);
            int q = 0, base = 0;
#pragma unroll
            for (int k = 1; k < kLatBoxes; ++k)
              if (e >= pre[k]) {
                q = k;
                base = pre[k];
              }
            const int nx = n_picks[2 * q + 1];
            const int yj = (e - base) / nx;
            by_next[j] = picks[2 * q * S + yj];
            bx_next[j] = picks[(2 * q + 1) * S + (e - base - yj * nx)];
            qs_next[j] = q;
            gv_next[j].load(grad +
                            ((size_t)(first + list[b0 + q]) * bins +
                             (by_next[j] & 0xffff) * output_size +
                             (bx_next[j] & 0xffff)) * channels + c0 + c);
          }
        };
        if (n_pairs > 0) fetch(0);
        for (int e0 = 0; e0 < n_pairs; e0 += kBatch) {
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            gv[j] = gv_next[j];
            by[j] = by_next[j];
            bx[j] = bx_next[j];
            qs[j] = qs_next[j];
          }
          if (e0 + kBatch < n_pairs) fetch(e0 + kBatch);
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (e0 + j >= n_pairs) break;  // the same for every thread
            const int4* ly_row =
                lat + 2 * qs[j] * S + (by[j] & 0xffff) * sampling_ratio;
            const int4* lx_row =
                lat + (2 * qs[j] + 1) * S + (bx[j] & 0xffff) * sampling_ratio;
            float g2[CPT];
            bool scaled = false;
            for (int sy = 0; sy < sampling_ratio; ++sy) {
              if (!(by[j] >> (16 + sy) & 1)) continue;
              const int4 ey = ly_row[sy];
              // this warp's rows among the sample's corner rows
              const bool y_lo = (ey.w & 1) && ey.x % kWarps == warp;
              const bool y_hi = (ey.w & 2) && ey.y % kWarps == warp;
              if (!y_lo && !y_hi) continue;  // the same for the warp
              if (!scaled) {
                scaled = true;
#pragma unroll
                for (int i = 0; i < CPT; ++i)
                  g2[i] = exact_inverse ? __fmul_rn(gv[j][i], inv_count)
                                        : __fdiv_rn(gv[j][i], count);
              }
              const float ly = __int_as_float(ey.z);
              const float hy = __fsub_rn(1.f, ly);
              for (int sx = 0; sx < sampling_ratio; ++sx) {
                if (!(bx[j] >> (16 + sx) & 1)) continue;
                const int4 ex = lx_row[sx];
                const float lx = __int_as_float(ex.z);
                const float hx = __fsub_rn(1.f, lx);
                // corners 00, 01, 10, 11 in the tile and in this warp's rows
                if (y_lo && (ex.w & 1))
                  add_term<CPT>(acc + (ey.x * kTileW + ex.x) * chunk + c, g2,
                                __fmul_rn(hy, hx));
                if (y_lo && (ex.w & 2))
                  add_term<CPT>(acc + (ey.x * kTileW + ex.y) * chunk + c, g2,
                                __fmul_rn(hy, lx));
                if (y_hi && (ex.w & 1))
                  add_term<CPT>(acc + (ey.y * kTileW + ex.x) * chunk + c, g2,
                                __fmul_rn(ly, hx));
                if (y_hi && (ex.w & 2))
                  add_term<CPT>(acc + (ey.y * kTileW + ex.y) * chunk + c, g2,
                                __fmul_rn(ly, lx));
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }
  if (touched) __syncthreads();  // the zeroed accumulator, if no box came

  // write the tile once, in the features' dtype
  TF* out = static_cast<TF*>(lv.ptr[lvl]) + (size_t)img * H * W * channels +
            c0;
  const int nvec = cc / VS;
  for (int k = tid; k < th * tw * nvec; k += blockDim.x) {
    const int p = k / nvec;
    const int v = k - p * nvec;
    const int py = p / tw;
    const int px = p - py * tw;
    float vals[VS];
    if (touched) {
      const float* src = acc + (py * kTileW + px) * chunk + v * VS;
      if constexpr (VS == 1) {
        vals[0] = src[0];
      } else {
#pragma unroll
        for (int e = 0; e < VS; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(src + e);
          vals[e] = f.x;
          vals[e + 1] = f.y;
          vals[e + 2] = f.z;
          vals[e + 3] = f.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < VS; ++e) vals[e] = 0.f;
    }
    store_vec<TF, VS>(
        out + ((size_t)(y0 + py) * W + (x0 + px)) * channels + v * VS, vals);
  }
}

template <typename TG, typename TF, int CPT, int VS>
cudaError_t launch_tiles(const roi_align::Levels<void*>& lv,
                         const TileMap& tm, const float* boxes,
                         const Scratch& sc, int boxes_per_image,
                         int channels, int output_size, int sampling_ratio,
                         const void* grad, cudaStream_t s) {
  // channel chunks of at most 32 * CPT (one warp's lanes), each a multiple
  // of CPT and of VS
  const int step = VS > CPT ? VS : CPT;
  const int n_chunks = (channels + 32 * CPT - 1) / (32 * CPT);
  int chunk = (channels + n_chunks - 1) / n_chunks;
  chunk = (chunk + step - 1) / step * step;
  const int S = output_size * sampling_ratio;
  const size_t smem = (size_t)kTileH * kTileW * chunk * sizeof(float) +
                      (size_t)kLatBoxes * 2 * S * (sizeof(int4) + sizeof(int));
  auto kernel = roi_tiles_kernel<TG, TF, CPT, VS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tm.blocks, (channels + chunk - 1) / chunk), kWarps * 32,
           smem, s>>>(lv, tm, boxes, sc, boxes_per_image, channels, chunk,
                      output_size, sampling_ratio,
                      static_cast<const TG*>(grad));
  return cudaSuccess;
}

template <typename TG, typename TF>
cudaError_t launch(const roi_align::Levels<void*>& lv, const TileMap& tm,
                   const float* boxes, const Scratch& sc,
                   int boxes_per_image, int channels, int output_size,
                   int sampling_ratio, const void* grad, bool aligned,
                   cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TF);
  if (aligned && channels % 8 == 0)
    return launch_tiles<TG, TF, 8, kVec>(lv, tm, boxes, sc, boxes_per_image,
                                         channels, output_size,
                                         sampling_ratio, grad, s);
  return launch_tiles<TG, TF, 1, 1>(lv, tm, boxes, sc, boxes_per_image,
                                    channels, output_size, sampling_ratio,
                                    grad, s);
}

}  // namespace

extern "C" {

// Bytes of device scratch aldi_roi_align_bwd needs for these levels and
// boxes (level_hw: host array of (H, W) pairs); -1 for bad arguments.
long long aldi_roi_align_bwd_scratch_bytes(const void* level_hw,
                                           int num_levels, int num_boxes,
                                           int boxes_per_image) {
  if (num_levels < 1 || num_levels > roi_align::kMaxLevels ||
      boxes_per_image < 1 || num_boxes % boxes_per_image)
    return -1;
  const int images = num_boxes / boxes_per_image;
  const TileMap tm = make_tile_map(static_cast<const int32_t*>(level_hw),
                                   num_levels, images);
  return (long long)scratch_bytes(tm, images, num_boxes);
}

// grad_dtype and out_dtype: 0 = float32, 1 = bfloat16 (the cotangent's and
// the features' dtype). level_ptrs is a host array of num_levels device
// pointers to the gradients to write, [B, H_l, W_l, channels] in out_dtype
// (uninitialised: every element is written), level_hw a host array of
// (H, W) pairs, level_scale a host array of 1/stride. boxes [num_boxes, 4]
// f32, levels [num_boxes] int32 and grad [num_boxes, output_size,
// output_size, channels] are on the device; box n belongs to image
// n / boxes_per_image. scratch is device memory of at least
// aldi_roi_align_bwd_scratch_bytes, 16-byte aligned. Returns the first
// CUDA error of the launches.
int aldi_roi_align_bwd(const void* level_ptrs, const void* level_hw,
                       const void* level_scale, int num_levels,
                       const void* boxes, const void* levels,
                       int boxes_per_image, int num_boxes, int channels,
                       int output_size, int sampling_ratio, int grad_dtype,
                       const void* grad, int out_dtype, void* scratch,
                       void* stream) {
  if (roi_align::bad_args(num_levels, num_boxes, channels, boxes_per_image,
                          output_size, sampling_ratio, grad_dtype) ||
      (out_dtype != 0 && out_dtype != 1) || num_boxes % boxes_per_image ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  const auto lv = roi_align::make_levels<void*>(level_ptrs, level_hw,
                                                level_scale, num_levels);
  const int images = num_boxes / boxes_per_image;
  const TileMap tm = make_tile_map(static_cast<const int32_t*>(level_hw),
                                   num_levels, images);
  const Scratch sc = carve(scratch, tm, images, num_boxes);
  const bool aligned = roi_align::levels_aligned(level_ptrs, num_levels) &&
                       reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  cudaError_t err =
      cudaMemsetAsync(sc.tile_flag, 0, (size_t)tm.blocks * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  roi_bins_kernel<<<images * num_levels, kBinThreads, 0, s>>>(
      lv, tm, b, static_cast<const int*>(levels), boxes_per_image,
      output_size, sampling_ratio, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (grad_dtype == 0 && out_dtype == 0)
    err = launch<float, float>(lv, tm, b, sc, boxes_per_image, channels,
                               output_size, sampling_ratio, grad, aligned, s);
  else if (grad_dtype == 0)
    err = launch<float, __nv_bfloat16>(lv, tm, b, sc, boxes_per_image,
                                       channels, output_size, sampling_ratio,
                                       grad, aligned, s);
  else if (out_dtype == 0)
    err = launch<__nv_bfloat16, float>(lv, tm, b, sc, boxes_per_image,
                                       channels, output_size, sampling_ratio,
                                       grad, aligned, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(
        lv, tm, b, sc, boxes_per_image, channels, output_size,
        sampling_ratio, grad, aligned, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* aldi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
