"""Self-distillation losses (ALDIDistiller semantics).

Port of ``aldi_tpu/engine/distill.py``: pure loss functions on the paired
outputs of the teacher and the student, which see the same sampled anchors
and the same sampled ROI set.

- RPN objectness: BCE(student logits, sigmoid(teacher logits / OBJ_TMP))
  over the anchors sampled against the pseudo-labels
- RPN regression: L1 on the sampled positives
- ROI classification: soft CE or KL at CLS_TMP
- ROI regression: L1 on the per-class deltas of the teacher's argmax class,
  where that class is foreground, normalized by the sampled proposals.

Every denominator is the global batch's: ``global_count`` all-reduces
it, so every rank calls these functions with the same flags, in the same
order (``parallel/mesh.py``'s contract).
"""

import torch

from ..ops.losses import (bce_with_logits, kl_div_log_targets, masked_mean,
                          smooth_l1, softmax_cross_entropy)
from ..mesh import global_count


def _global_mean(values, mask):
    """``masked_mean`` over the global batch: the rank's masked sum over
    the mask's count summed across the ranks (``global_count``)."""
    mask = mask.to(values.dtype)
    return masked_mean(values, mask, count=global_count(mask.sum()))


def rpn_distill_losses(
    student_logits: torch.Tensor,  # [B, K] at the sampled anchors
    student_deltas: torch.Tensor,  # [B, K, 4]
    teacher_logits: torch.Tensor,  # [B, K]
    teacher_deltas: torch.Tensor,  # [B, K, 4]
    valid: torch.Tensor,  # [B, K] sampled (pos or neg) vs pseudo-labels
    fg: torch.Tensor,  # [B, K] sampled positives
    obj_temperature: float = 1.0,
    do_obj: bool = True,
    do_reg: bool = True,
) -> dict:
    out = {}
    if do_obj:
        t_probs = torch.sigmoid(teacher_logits / obj_temperature)
        obj = bce_with_logits(student_logits, t_probs)
        out["loss_obj_bce"] = _global_mean(obj, valid)
    if do_reg:
        reg = smooth_l1(student_deltas, teacher_deltas, 0.0)
        out["loss_rpn_l1"] = _global_mean(reg, fg[..., None].expand_as(reg))
    return out


def roih_distill_losses(
    student_cls: torch.Tensor,  # [B, S, K+1]
    student_deltas: torch.Tensor,  # [B, S, K*4]
    teacher_cls: torch.Tensor,  # [B, S, K+1]
    teacher_deltas: torch.Tensor,  # [B, S, K*4]
    sampled_valid: torch.Tensor,  # [B, S]
    num_classes: int,
    cls_temperature: float = 1.0,
    cls_loss_type: str = "CE",
    do_cls: bool = True,
    do_reg: bool = True,
) -> dict:
    out = {}
    if do_cls:
        if cls_loss_type == "CE":
            t_probs = torch.softmax(teacher_cls / cls_temperature, dim=-1)
            ce = softmax_cross_entropy(student_cls, t_probs)
            out["loss_cls_ce"] = _global_mean(ce, sampled_valid)
        elif cls_loss_type == "KL":
            kl = kl_div_log_targets(
                torch.log_softmax(student_cls, dim=-1),
                torch.log_softmax(teacher_cls / cls_temperature, dim=-1))
            out["loss_cls_ce"] = _global_mean(kl, sampled_valid)
        else:
            raise ValueError(
                f"cls_loss_type must be CE or KL: {cls_loss_type}")
    if do_reg:
        fg_cls = teacher_cls.argmax(dim=-1)  # [B, S]
        fg = (fg_cls != num_classes) & sampled_valid
        idx = fg_cls.clamp(0, num_classes - 1)[..., None, None].expand(
            fg_cls.shape + (1, 4))
        shape = student_deltas.shape[:-1] + (num_classes, 4)
        sd = torch.gather(student_deltas.reshape(shape), -2, idx).squeeze(-2)
        td = torch.gather(teacher_deltas.reshape(shape), -2, idx).squeeze(-2)
        reg = smooth_l1(sd, td, 0.0).sum(-1)
        normalizer = global_count(sampled_valid.sum()).clamp(min=1)
        out["loss_roih_l1"] = (reg * fg).sum() / normalizer
    return out


_HARD_KEYS = {  # standard loss -> the DISTILL flag that keeps it
    # R-CNN (reference aldi/distill.py:175-180)
    "loss_cls": "HARD_ROIH_CLS_ENABLED",
    "loss_rpn_cls": "HARD_OBJ_ENABLED",
    "loss_rpn_loc": "HARD_RPN_REG_ENABLED",
    "loss_box_reg": "HARD_ROIH_REG_ENABLED",
    # YOLO (reference aldi/yolo/distill.py:90-94); its loss_cls is above
    "loss_obj": "HARD_OBJ_ENABLED",
    "loss_box": "HARD_ROIH_REG_ENABLED",
}


def gate_hard_losses(standard_losses: dict, cfg) -> dict:
    """Keep or zero the student's standard losses on pseudo-labels by the
    HARD_* flags; a zeroed loss stays in the dict (times 0.0) so the metric
    keys are the same on every step."""
    d = cfg.DOMAIN_ADAPT.DISTILL
    out = {}
    for k, v in standard_losses.items():
        flag = _HARD_KEYS.get(k)
        out[k] = v if flag is not None and d[flag] else v * 0.0
    return out
