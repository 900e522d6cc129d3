"""Loss primitives of the R-CNN, YOLO and DETR families.

Port of ``aldi_tpu/ops/losses.py``. All take explicit masks instead of
ragged filtering and return per-element or per-row values; callers reduce
and normalize.
"""

import torch

from .boxes import box_area


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 0.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber); beta < 1e-5 is pure L1."""
    diff = torch.abs(pred - target)
    if beta < 1e-5:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits, in the JAX package's
    form ``max(x, 0) - x*z + log1p(exp(-|x|))``."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          dim: int = -1) -> torch.Tensor:
    """Per-row cross entropy with integer labels or soft target
    distributions (no reduction)."""
    log_probs = torch.log_softmax(logits, dim=dim)
    if not torch.is_floating_point(targets):
        return -torch.gather(log_probs, dim,
                             targets.long().unsqueeze(dim)).squeeze(dim)
    return -(targets * log_probs).sum(dim=dim)


def kl_div_log_targets(student_log_probs: torch.Tensor,
                       teacher_log_probs: torch.Tensor) -> torch.Tensor:
    """KL(teacher || student) with log-space targets, summed per row."""
    t = torch.exp(teacher_log_probs)
    return (t * (teacher_log_probs - student_log_probs)).sum(dim=-1)


def sigmoid_focal(logits: torch.Tensor, targets: torch.Tensor,
                  alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (RetinaNet/DETR form)."""
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def giou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise 1 - GIoU for paired [..., 4] xyxy boxes."""
    area_p = box_area(pred)
    area_t = box_area(target)
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_p + area_t - inter
    zero = torch.zeros_like(inter)
    iou = torch.where(union > 0, inter / union, zero)
    lt_e = torch.minimum(pred[..., :2], target[..., :2])
    rb_e = torch.maximum(pred[..., 2:], target[..., 2:])
    wh_e = (rb_e - lt_e).clamp(min=0)
    area_e = wh_e[..., 0] * wh_e[..., 1]
    return 1.0 - (iou - torch.where(area_e > 0, (area_e - union) / area_e,
                                    zero))


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Mean of ``values`` where ``mask``; safe when the mask is empty."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp(min=eps)
