"""Loss primitives of the R-CNN, YOLO and DETR families.

Port of ``aldi_tpu/ops/losses.py``. All take explicit masks instead of
ragged filtering and return per-element or per-row values; callers reduce
and normalize.
"""

import torch



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


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-8, count=None) -> torch.Tensor:
    """Mean of ``values`` where ``mask``; safe when the mask is empty.
    ``count``: the denominator, by default the mask's own count (a
    data-parallel caller passes the global batch's)."""
    mask = mask.to(values.dtype)
    count = mask.sum() if count is None else count
    return (values * mask).sum() / count.clamp(min=eps)
