"""Least time of one launch of K2, the ROIAlign forward and backward over
the pyramid (7x7 bins, sampling ratio 2).

Forward: bytes (each feature row that the launch's samples touch read once,
boxes and levels read once, the output written once) against float32
operations (4 corner products and 4 sums per sample and channel that reads
features) over the CUDA-core rate. Backward: bytes (the cotangent, boxes and
levels read once, the dense per-level gradient written once in the
cotangent's dtype) against the same operations."""

import torch

from ..reference.ops.roi_align import sample_geometry
from . import peaks

STRIDES = [4, 8, 16, 32]


def fwd_bound_s(feat_hws, channels, esize, boxes, levels, output_size=7,
                sampling_ratio=2) -> float:
    b, p = boxes.shape[:2]
    rows = samples = 0
    for i in range(b):
        idx4, _, ok = sample_geometry(boxes[i], levels[i], feat_hws, STRIDES,
                                      output_size, sampling_ratio)
        rows += torch.unique(torch.cat([idx[ok] for idx in idx4])).numel()
        samples += int(ok.sum())
    n_bytes = (rows * channels * esize
               + b * p * output_size ** 2 * channels * esize
               + boxes.numel() * 4 + levels.numel() * 4)
    return max(n_bytes / peaks.BYTES_PER_S,
               samples * channels * 8 / peaks.F32_FLOPS)


def bwd_bound_s(grad_shape, esize, boxes, levels, feat_hws,
                sampling_ratio=2) -> float:
    b, _, out, _, c = grad_shape
    samples = sum(int(sample_geometry(boxes[i], levels[i], feat_hws, STRIDES,
                                      out, sampling_ratio)[2].sum())
                  for i in range(b))
    n_elems = 1
    for d in grad_shape:
        n_elems *= d
    n_bytes = (n_elems * esize + boxes.numel() * 4 + levels.numel() * 4
               + b * sum(h * w for h, w in feat_hws) * c * esize)
    return max(n_bytes / peaks.BYTES_PER_S,
               samples * c * 8 / peaks.F32_FLOPS)
