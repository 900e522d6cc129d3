"""Second stage: proposal sampling, box pooler, box head, Fast R-CNN
losses and inference.

Port of ``aldi_tpu/models/roi_heads.py``. Class logits are [N, K+1] with
background last; deltas are [N, K*4]. Sampling is batched over images and
takes its draws as tensors (``ops/matcher.py``); the DAOD step hands the
same sampled set to the student's and the teacher's box heads.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.losses import smooth_l1, softmax_cross_entropy
from ..ops.matcher import match, sample_fixed_indices, subsample_labels
from ..ops.nms import batched_nms_keep_mask, top_k
from ..ops.roi_align import roi_align_batched
from ..mesh import global_count
from .layers import Conv2d, ConvNorm, Linear


class FastRCNNConvFCHead(nn.Module):
    """Pooled features [N, r, r, C] (NHWC) -> conv* -> fc* with ReLU
    (``aldi_tpu/models/roi_heads.py:27-54``). ``num_conv`` 3x3 convs of
    ``conv_dim``, bias-free and followed by a channel LayerNorm (eps 1e-6)
    when ``norm == "LN"`` (the ViTDet configs), each then ReLU; the result is
    flattened in (h, w, c) order, as in the JAX package (a detectron2
    checkpoint's (c, h, w) ``fc1`` needs the permutation of
    ``aldi_tpu/engine/checkpoint_convert.py:380-392``)."""

    def __init__(self, in_channels, resolution, num_fc=2, fc_dim=1024,
                 num_conv=0, norm="", compute_dtype=torch.float32,
                 conv_dim=256):
        super().__init__()
        if norm not in ("", "LN"):
            raise NotImplementedError(
                f"MODEL.ROI_BOX_HEAD.NORM={norm!r}: the box head takes '' or "
                "'LN'")
        self.num_conv, self.num_fc = num_conv, num_fc
        dt = compute_dtype
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", ConvNorm(
                in_channels, conv_dim, 3, compute_dtype=dt) if norm else
                Conv2d(in_channels, conv_dim, 3, padding=1, compute_dtype=dt))
            in_channels = conv_dim
        dim = in_channels * resolution * resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim,
                                                 compute_dtype=dt))
            dim = fc_dim

    def forward(self, x):
        if self.num_conv:
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_conv):
                x = F.relu(getattr(self, f"conv{i + 1}")(x))
            x = x.permute(0, 2, 3, 1)
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


def _take(x, idx):
    """x [B, N, ...] gathered at idx [B, K] along dim 1."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


def sample_proposals(
    proposals: torch.Tensor,  # [B, N, 4]
    prop_valid: torch.Tensor,  # [B, N]
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_classes: torch.Tensor,  # [B, G]
    gt_valid: torch.Tensor,  # [B, G]
    draws: dict,
    num_classes: int,
    batch_size_per_image: int = 512,
    positive_fraction: float = 0.25,
    iou_threshold: float = 0.5,
    append_gt: bool = True,
):
    """Substrate ``label_and_sample_proposals``: match the candidates
    (proposals [+ gt]) to gt, assign classes (background = num_classes),
    sample a fixed-size balanced set. ``draws`` are those of
    ``ops.matcher.sample_proposals_draws`` for the [B, N (+ G)] candidates.

    Returns a dict of boxes [B, S, 4], classes [B, S], target_boxes
    [B, S, 4], valid [B, S], is_pos [B, S]."""
    if append_gt:
        proposals = torch.cat([proposals, gt_boxes.to(proposals.dtype)], 1)
        prop_valid = torch.cat([prop_valid, gt_valid], 1)
    iou = box_ops.pairwise_iou(proposals, gt_boxes)
    midx, mlab = match(iou, gt_valid, [iou_threshold], [0, 1], False)
    bg = torch.full((), num_classes, dtype=torch.int32,
                    device=proposals.device)
    classes = torch.where(mlab == 1, torch.gather(
        gt_classes.to(torch.int32), 1, midx.long()), bg)
    # invalid candidates get the ignore label so they are never sampled
    for_sampling = torch.where(prop_valid, classes, torch.full_like(
        classes, -1))
    pos, neg = subsample_labels(for_sampling, batch_size_per_image,
                                positive_fraction, num_classes, draws)
    idx, valid, is_pos = sample_fixed_indices(pos, neg, batch_size_per_image,
                                              draws["fill"])
    return {
        "boxes": _take(proposals, idx),
        "classes": torch.where(valid, _take(classes, idx), bg),
        "target_boxes": _take(_take(gt_boxes, midx), idx),
        "valid": valid,
        "is_pos": is_pos,
    }


def box_pooler(features, boxes, valid, strides, resolution=7):
    """Multi-level ROIAlign over NHWC levels -> [B, S, res, res, C],
    differentiable in the features."""
    return roi_align_batched(features, boxes, valid, strides, resolution)


def fast_rcnn_losses(
    cls_logits: torch.Tensor,  # [B, S, K+1]
    deltas: torch.Tensor,  # [B, S, K*4]
    sampled: dict,
    num_classes: int,
    box_reg_weights=(10.0, 10.0, 5.0, 5.0),
    smooth_l1_beta: float = 0.0,
) -> dict:
    """Substrate ``FastRCNNOutputLayers.losses``: softmax CE averaged over
    the sampled proposals; smooth-L1 on the gt-class deltas of foreground
    proposals, normalized by the number of sampled proposals (the global
    batch's under data parallelism: ``global_count``, an all-reduce that
    every rank makes, in the same order, ``parallel/mesh.py``)."""
    valid = sampled["valid"]
    classes = sampled["classes"]
    n_valid = global_count(valid.sum()).clamp(min=1)
    ce = softmax_cross_entropy(cls_logits.to(torch.float32), classes)
    loss_cls = (ce * valid).sum() / n_valid
    fg = valid & (classes < num_classes)
    target = box_ops.encode_deltas(sampled["boxes"], sampled["target_boxes"],
                                   box_reg_weights)
    d = deltas.reshape(deltas.shape[:-1] + (num_classes, 4)).to(torch.float32)
    cls_idx = classes.clamp(0, num_classes - 1).long()
    d_fg = torch.gather(d, -2, cls_idx[..., None, None].expand(
        cls_idx.shape + (1, 4))).squeeze(-2)
    reg = smooth_l1(d_fg, target, smooth_l1_beta).sum(-1)
    loss_reg = (reg * fg).sum() / n_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_reg}


def inference_candidates(
    proposals: torch.Tensor,  # [B, N, 4]
    prop_valid: torch.Tensor,  # [B, N]
    cls_logits: torch.Tensor,  # [B, N, K+1]
    deltas: torch.Tensor,  # [B, N, K*4]
    image_sizes: torch.Tensor,  # [B, 2]
    num_classes: int,
    score_thresh: float = 0.05,
    box_reg_weights=(10.0, 10.0, 5.0, 5.0),
    nms_candidates: int = 2000,
):
    """The (box, class) pairs that enter ``fast_rcnn_inference``'s NMS:
    per-class decode, clip, score threshold, the top ``nms_candidates`` by
    score. Returns (boxes [B, C, 4], scores [B, C], classes [B, C], valid
    [B, C]). Softmax, decode and clip run in float32."""
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
    vals, idx = top_k(torch.where(flat_valid, flat_scores, neg_inf), k)
    bx = torch.gather(flat_boxes, 1, idx[..., None].expand(-1, -1, 4))
    cl = torch.gather(flat_cls, 1, idx)
    vl = torch.gather(flat_valid, 1, idx) & torch.isfinite(vals)
    return bx, vals, cl, vl


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
    candidates=None,
):
    """Substrate ``fast_rcnn_inference``: per-class decode, score threshold,
    class-aware NMS over ``inference_candidates``, top-k. Returns (boxes
    [B, D, 4], scores [B, D], classes [B, D], valid [B, D]); a list passed
    as ``candidates`` receives the candidates."""
    bx, vals, cl, vl = inference_candidates(
        proposals, prop_valid, cls_logits, deltas, image_sizes, num_classes,
        score_thresh, box_reg_weights, nms_candidates)
    if candidates is not None:
        candidates.append((bx, vals, cl, vl))
    keep = batched_nms_keep_mask(bx, vals, cl, vl, nms_thresh) & vl
    final_scores, order = top_k(
        torch.where(keep, vals, torch.full_like(vals, -torch.inf)),
        topk_per_image)
    return (torch.gather(bx, 1, order[..., None].expand(-1, -1, 4)),
            final_scores, torch.gather(cl, 1, order),
            torch.isfinite(final_scores))
