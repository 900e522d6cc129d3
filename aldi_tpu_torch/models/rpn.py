"""Region Proposal Network: head module + proposal generation.

Port of the inference half of ``aldi_tpu/models/rpn.py``; anchor labels and
losses come with the training slice. Flattened (H, W, A) ordering matches
``ops/anchors.py``, so logits/deltas/anchors align index for index.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.nms import nms_keep_mask, top_k_by_score
from .layers import Conv2d


class StandardRPNHead(nn.Module):
    """3x3 conv + 1x1 objectness / 1x1 anchor-delta heads, shared across
    levels. Takes NCHW levels; returns per level ([B, HWA], [B, HWA, 4])."""

    def __init__(self, in_channels, num_anchors, conv_dims=(-1,),
                 compute_dtype=torch.float32):
        super().__init__()
        if tuple(conv_dims) != (-1,):
            raise NotImplementedError(
                "MODEL.RPN.CONV_DIMS other than [-1] (ViTDet configs) is not "
                "ported yet: ROADMAP.md, ViTDet slice")
        kw = dict(compute_dtype=compute_dtype, init_std=0.01)
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1, **kw)
        self.objectness_logits = Conv2d(in_channels, num_anchors, 1, **kw)
        self.anchor_deltas = Conv2d(in_channels, num_anchors * 4, 1, **kw)

    def forward(self, features: List[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            # channel a*4+k of anchor_deltas is coordinate k of anchor a
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1)
                          .reshape(b, -1))
            deltas.append(self.anchor_deltas(t).permute(0, 2, 3, 1)
                          .reshape(b, -1, 4))
        return logits, deltas


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
        s, idx = torch.topk(lg.float(), k, dim=1)  # [B, k]
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
