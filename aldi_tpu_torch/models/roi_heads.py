"""Second stage at inference: box pooler, box head, Fast R-CNN inference.

Port of the inference half of ``aldi_tpu/models/roi_heads.py``; proposal
sampling and losses come with the training slice. Class logits are
[N, K+1] with background last; deltas are [N, K*4].
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.nms import batched_nms_keep_mask
from ..ops.roi_align import roi_align_batched
from .layers import Linear


class FastRCNNConvFCHead(nn.Module):
    """Pooled features [N, r, r, C] (NHWC) -> fc* with ReLU. The input is
    flattened in (h, w, c) order, as in the JAX package; a detectron2
    checkpoint's (c, h, w) ``fc1`` needs the permutation of
    ``aldi_tpu/engine/checkpoint_convert.py:380-392``."""

    def __init__(self, in_channels, resolution, num_fc=2, fc_dim=1024,
                 num_conv=0, norm="", compute_dtype=torch.float32):
        super().__init__()
        if num_conv or norm:
            raise NotImplementedError(
                "conv box heads (MODEL.ROI_BOX_HEAD.NUM_CONV/NORM, ViTDet "
                "configs) are not ported yet: ROADMAP.md, ViTDet slice")
        self.num_fc = num_fc
        dim = in_channels * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim,
                                                 compute_dtype=compute_dtype))
            dim = fc_dim

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    """cls logits [N, K+1] (background last) + per-class deltas [N, K*4]."""

    def __init__(self, in_features, num_classes, compute_dtype=torch.float32):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes + 1,
                                compute_dtype=compute_dtype, init_std=0.01)
        self.bbox_pred = Linear(in_features, num_classes * 4,
                                compute_dtype=compute_dtype, init_std=0.001)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


def box_pooler(features, boxes, valid, strides, resolution=7):
    """Multi-level ROIAlign over NHWC levels -> [B, S, res, res, C]."""
    return roi_align_batched(features, boxes, valid, strides, resolution)


def fast_rcnn_inference(
    proposals: torch.Tensor,  # [B, N, 4]
    prop_valid: torch.Tensor,  # [B, N]
    cls_logits: torch.Tensor,  # [B, N, K+1]
    deltas: torch.Tensor,  # [B, N, K*4]
    image_sizes: torch.Tensor,  # [B, 2]
    num_classes: int,
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    topk_per_image: int = 100,
    box_reg_weights=(10.0, 10.0, 5.0, 5.0),
    nms_candidates: int = 2000,
):
    """Substrate ``fast_rcnn_inference``: per-class decode, score threshold,
    class-aware NMS, top-k. Returns (boxes [B, D, 4], scores [B, D],
    classes [B, D], valid [B, D]).

    ``nms_candidates`` caps the (box, class) pairs entering NMS by score, a
    static-shape prefilter; with topk_per_image=100 the tail never survives.
    Softmax, decode and clip run in float32.
    """
    b, n, _ = proposals.shape
    dev = proposals.device
    scores = torch.softmax(cls_logits.float(), dim=-1)[..., :-1]
    pred = box_ops.decode_deltas(deltas.float(), proposals.float(),
                                 box_reg_weights).reshape(b, n, num_classes, 4)
    sizes = image_sizes.to(torch.float32)
    pred = box_ops.clip_boxes(
        pred, (sizes[:, 0, None, None], sizes[:, 1, None, None]))

    flat_boxes = pred.reshape(b, n * num_classes, 4)
    flat_scores = scores.reshape(b, n * num_classes)
    flat_cls = torch.arange(num_classes, dtype=torch.int32,
                            device=dev).repeat(b, n)
    flat_valid = ((flat_scores > score_thresh)
                  & prop_valid.repeat_interleave(num_classes, dim=1)
                  & box_ops.nonempty(flat_boxes))

    k = min(nms_candidates, n * num_classes)
    neg_inf = torch.full_like(flat_scores, -torch.inf)
    vals, idx = torch.topk(torch.where(flat_valid, flat_scores, neg_inf), k,
                           dim=1)
    bx = torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4))
    cl = torch.gather(flat_cls, 1, idx)
    vl = torch.gather(flat_valid, 1, idx) & torch.isfinite(vals)
    keep = batched_nms_keep_mask(bx, vals, cl, vl, nms_thresh) & vl
    final_scores, order = torch.topk(
        torch.where(keep, vals, torch.full_like(vals, -torch.inf)),
        topk_per_image, dim=1)
    return (torch.gather(bx, 1, order[..., None].expand(-1, -1, 4)),
            final_scores, torch.gather(cl, 1, order),
            torch.isfinite(final_scores))
