"""Least time of one launch of K1a (``match_iou``) and of K1b
(``low_quality_mask``), the anchor matcher: bytes (the anchors read once,
the gt, flags and, for K1b, the per-gt best read once, the outputs written
once: K1a 8 B per anchor and image plus the per-gt best, K1b 1 B) against
``MATCH_OPS`` float32 operations per IoU that these inputs need (one per
(anchor, gt slot) pair whose boxes intersect, among the valid slots, or for
K1b the valid slots whose best IoU is above 0) over the CUDA-core rate."""

import torch

from . import peaks

MATCH_OPS = 12  # float operations per IoU (4 min/max, 3 sub, 2 mul, add, div)


def intersecting_pairs(anchors, gt, keep) -> int:
    """The (anchor, gt slot) pairs among the slots ``keep`` [B, M] whose
    boxes intersect: the only pairs whose IoU is not 0."""
    pairs = 0
    for g, k in zip(gt, keep):
        g = g[k]
        for s in range(0, g.shape[0], 16):
            part = g[s:s + 16]
            lt = torch.maximum(anchors[:, None, :2], part[None, :, :2])
            rb = torch.minimum(anchors[:, None, 2:], part[None, :, 2:])
            wh = (rb - lt).clamp(min=0)
            pairs += int(((wh[..., 0] * wh[..., 1]) > 0).sum())
    return pairs


def bound_s(kind, anchors, gt, gt_valid, best=None) -> float:
    """Seconds: ``kind`` "match_iou" (K1a) or "low_quality_mask" (K1b)."""
    n = anchors.shape[0]
    b, m = gt_valid.shape
    gt_bytes = b * m * 17
    if kind == "match_iou":
        keep, n_bytes = gt_valid, n * 16 + gt_bytes + b * n * 8 + b * m * 4
    else:
        keep = gt_valid & (best > 0)
        n_bytes = n * 16 + gt_bytes + b * m * 4 + b * n
    ops = intersecting_pairs(anchors, gt, keep) * MATCH_OPS
    return max(n_bytes / peaks.BYTES_PER_S, ops / peaks.F32_FLOPS)
