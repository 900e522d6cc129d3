"""Padded, batched detection structures.

Port of ``aldi_tpu/structures.py``: ragged per-image instance sets become
struct-of-tensors padded to a fixed row count (``TPU.MAX_GT`` for ground
truth and pseudo-labels), with a boolean ``valid`` mask marking real rows.
Boxes are ``[B, N, 4]`` XYXY in absolute pixels.
"""

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Instances:
    """A padded batch of per-image instance sets; all tensors share the
    leading dims ``[B, N]``."""

    boxes: torch.Tensor  # [B, N, 4] xyxy float32
    classes: torch.Tensor  # [B, N] int32
    valid: torch.Tensor  # [B, N] bool
    scores: Optional[torch.Tensor] = None  # [B, N] float, optional
