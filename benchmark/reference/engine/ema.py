"""EMA teacher update.

Port of ``aldi_tpu/engine/ema.py`` and of the step's EMA of the mutable
model state (``aldi_tpu/engine/train_step.py:142-155``): per step ``t =
s*(1-alpha) + t*alpha`` over the teacher's parameters and its
floating-point buffers (YOLO's BatchNorm running statistics, the JAX
package's ``ema_model_state``), a plain copy at ``step <= start_iter``,
and a copy for parameters whose name contains one of ``exclude_keys``. A
buffer the teacher shares with the student (the R-CNN families' FrozenBN
statistics, ``engine/train_step.py`` ``create_train_state``) is the same
tensor on both sides and is skipped. The JAX package builds a new tree;
here the teacher is updated in place, with ``torch._foreach_*`` over all
its tensors at once, which keeps one copy of the teacher in memory.
"""

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module,
               alpha: float, step: int, start_iter: int = 0,
               exclude_keys: Sequence[str] = ("query_embed",)) -> None:
    """Blend ``student``'s parameters and floating-point buffers into
    ``teacher``'s (same names), in place. ``step`` is the current
    iteration; at ``step <= start_iter`` the teacher is (re)initialized to
    a copy of the student."""
    s_params = dict(student.named_parameters())
    s_buffers = dict(student.named_buffers())
    pairs = [(n, t, s_params[n]) for n, t in teacher.named_parameters()]
    pairs += [(n, t, s_buffers[n]) for n, t in teacher.named_buffers()
              if t.is_floating_point() and t is not s_buffers[n]]
    blend_t, blend_s, copy_t, copy_s = [], [], [], []
    for name, t, s in pairs:
        if step <= start_iter or any(k in name for k in exclude_keys):
            copy_t.append(t)
            copy_s.append(s)
        else:
            blend_t.append(t)
            blend_s.append(s)
    if copy_t:
        torch._foreach_copy_(copy_t, copy_s)
    if blend_t:
        torch._foreach_mul_(blend_t, alpha)
        torch._foreach_add_(blend_t, blend_s, alpha=1.0 - alpha)
