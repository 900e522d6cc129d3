"""Region Proposal Network: head module, anchor labels and losses,
proposal generation.

Port of ``aldi_tpu/models/rpn.py``. Flattened (H, W, A) ordering matches
``ops/anchors.py``, so logits/deltas/anchors align index for index. Anchor
labelling runs on the K sampled anchors per image (the JAX package's
``TPU.RPN_LOSS_IMPL="sampled"``), batched over images: one matcher call
(kernels K1a/K1b on the card) and one sampler call for the whole batch.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.losses import bce_with_logits, smooth_l1
from ..ops.match_kernel import match_boxes
from ..ops.matcher import subsample_indices
from ..ops.nms import nms_keep_mask, top_k, top_k_by_score
from .layers import Conv2d


class StandardRPNHead(nn.Module):
    """3x3 conv stack + 1x1 objectness / 1x1 anchor-delta heads, shared
    across levels (``aldi_tpu/models/rpn.py:27-61``). ``conv_dims`` is
    MODEL.RPN.CONV_DIMS (-1 = the input channels): one conv is named
    ``conv``, several ``conv0``, ``conv1``, ..., each followed by ReLU (the
    ViTDet configs use two). Takes NCHW levels; returns per level
    ([B, HWA], [B, HWA, 4])."""

    def __init__(self, in_channels, num_anchors, conv_dims=(-1,),
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, init_std=0.01)
        self.conv_names = []
        dim = in_channels
        for i, d in enumerate(conv_dims):
            name = "conv" if len(conv_dims) == 1 else f"conv{i}"
            out = in_channels if d == -1 else d
            self.add_module(name, Conv2d(dim, out, 3, padding=1, **kw))
            self.conv_names.append(name)
            dim = out
        self.objectness_logits = Conv2d(dim, num_anchors, 1, **kw)
        self.anchor_deltas = Conv2d(dim, num_anchors * 4, 1, **kw)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = f
            for name in self.conv_names:
                t = F.relu(getattr(self, name)(t))
            b = f.shape[0]
            # channel a*4+k of anchor_deltas is coordinate k of anchor a
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1)
                          .reshape(b, -1))
            deltas.append(self.anchor_deltas(t).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4))
        return logits, deltas


def label_anchors_sampled(
    anchors: torch.Tensor,  # [R, 4] all levels concatenated
    gt_boxes: torch.Tensor,  # [B, G, 4]
    gt_valid: torch.Tensor,  # [B, G]
    draws: dict,
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    thresholds=(0.3, 0.7),
):
    """Substrate ``label_and_sample_anchors`` reduced to exactly
    K = min(batch_size_per_image, R) sampled anchors per image
    (``aldi_tpu/models/rpn.py:155-208``). ``draws`` are those of
    ``subsample_indices`` for labels [B, R]. Returns (idx [B, K], valid
    [B, K], is_pos [B, K], matched_gt [B, K, 4])."""
    k = min(batch_size_per_image, anchors.shape[0])
    midx, mlab = match_boxes(anchors, gt_boxes.to(torch.float32), gt_valid,
                             list(thresholds), [0, -1, 1],
                             allow_low_quality=True)
    idx, valid, is_pos = subsample_indices(mlab.to(torch.int32), k,
                                           positive_fraction, 0, draws)
    gt_idx = torch.gather(midx, 1, idx).long()
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    return idx, valid, is_pos, matched


def rpn_losses(
    anchors: torch.Tensor,  # [R, 4]
    logits: torch.Tensor,  # [B, R]
    deltas: torch.Tensor,  # [B, R, 4]
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    draws: dict,
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    box_reg_weights=(1.0, 1.0, 1.0, 1.0),
    smooth_l1_beta: float = 0.0,
) -> dict:
    """Substrate RPN losses on the K sampled anchors: objectness BCE over the
    sampled set and smooth-L1 delta regression over its positives, each
    normalized by B * batch_size_per_image."""
    idx, valid, is_pos, matched_gt = label_anchors_sampled(
        anchors, gt_boxes, gt_valid, draws, batch_size_per_image,
        positive_fraction)
    normalizer = logits.shape[0] * batch_size_per_image
    lg = torch.gather(logits, 1, idx).to(torch.float32)
    obj = bce_with_logits(lg, is_pos.to(torch.float32))
    loss_cls = (obj * valid).sum() / normalizer
    dl = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    target = box_ops.encode_deltas(anchors[idx], matched_gt, box_reg_weights)
    reg = smooth_l1(dl.to(torch.float32), target, smooth_l1_beta).sum(-1)
    loss_loc = (reg * is_pos).sum() / normalizer
    return {"loss_rpn_cls": loss_cls, "loss_rpn_loc": loss_loc}


def generate_proposals(
    logits: List[torch.Tensor],  # per level [B, HWA_l]
    deltas: List[torch.Tensor],  # per level [B, HWA_l, 4]
    anchors: List[torch.Tensor],  # per level [HWA_l, 4]
    image_sizes: torch.Tensor,  # [B, 2] (h, w)
    pre_nms_topk: int,
    post_nms_topk: int,
    nms_thresh: float = 0.7,
    min_size: float = 0.0,
    box_reg_weights=(1.0, 1.0, 1.0, 1.0),
):
    """Substrate ``find_top_rpn_proposals``: per-level top-k by objectness,
    decode + clip + per-level NMS, then global top-k. Static shapes; returns
    (boxes [B, K, 4], scores [B, K], valid [B, K]). Objectness is ranked
    and deltas decoded and clipped in float32."""
    sizes = image_sizes.to(torch.float32)
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for lg, dl, an in zip(logits, deltas, anchors):
        k = min(pre_nms_topk, lg.shape[1])
        s, idx = top_k(lg.float(), k)  # [B, k]
        d = torch.gather(dl, 1, idx[..., None].expand(-1, -1, 4))
        bx = box_ops.decode_deltas(d.float(), an[idx], box_reg_weights)
        bx = box_ops.clip_boxes(bx, (sizes[:, 0, None], sizes[:, 1, None]))
        v = box_ops.nonempty(bx, min_size) & torch.isfinite(s)
        # pad the level to pre_nms_topk so levels stack uniformly
        pad = pre_nms_topk - k
        if pad:
            bx = F.pad(bx, (0, 0, 0, pad))
            s = F.pad(s, (0, pad), value=-torch.inf)
            v = F.pad(v, (0, pad))
        lvl_boxes.append(bx)
        lvl_scores.append(s)
        lvl_valid.append(v)

    boxes_l = torch.stack(lvl_boxes, 1)  # [B, L, K, 4]
    scores_l = torch.stack(lvl_scores, 1)
    valid_l = torch.stack(lvl_valid, 1)
    # every (image, level) pair in one batched NMS
    keep = nms_keep_mask(boxes_l, scores_l, valid_l, nms_thresh)

    b = boxes_l.shape[0]
    flat_scores = torch.where(keep, scores_l,
                              torch.full_like(scores_l, -torch.inf))
    return top_k_by_score(boxes_l.reshape(b, -1, 4), flat_scores.reshape(b, -1),
                          (keep & valid_l).reshape(b, -1), post_nms_topk)
