"""Pseudo-labels from teacher detections, on the device.

Port of ``aldi_tpu/engine/pseudolabel.py``: threshold the teacher's
detections (canvas coordinates) and pad or trim them to ``max_gt`` rows, as
a padded ``Instances``.
"""

import torch
import torch.nn.functional as F

from ..structures import Instances


def detections_to_pseudo_labels(
    boxes: torch.Tensor,  # [B, D, 4]
    scores: torch.Tensor,  # [B, D]
    classes: torch.Tensor,  # [B, D]
    valid: torch.Tensor,  # [B, D]
    threshold: float,
    max_gt: int,
) -> Instances:
    """Detections arrive sorted by score (inference top-k), so trimming
    keeps the highest-scoring ones."""
    keep = valid & (scores > threshold)
    d = boxes.shape[1]
    if d >= max_gt:
        boxes, scores, classes, keep = (boxes[:, :max_gt], scores[:, :max_gt],
                                        classes[:, :max_gt], keep[:, :max_gt])
    else:
        pad = max_gt - d
        boxes = F.pad(boxes, (0, 0, 0, pad))
        scores = F.pad(scores, (0, pad))
        classes = F.pad(classes, (0, pad))
        keep = F.pad(keep, (0, pad))
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return Instances(
        boxes=torch.where(keep[..., None], boxes, zero),
        classes=torch.where(keep, classes, torch.zeros_like(classes)).to(
            torch.int32),
        valid=keep,
        scores=torch.where(keep, scores, torch.zeros_like(scores)),
    )
