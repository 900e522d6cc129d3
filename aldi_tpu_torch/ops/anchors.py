"""Anchor generation (DefaultAnchorGenerator semantics).

A copy of ``aldi_tpu/ops/anchors.py`` (plain numpy), kept here so the port
imports nothing of the JAX package. Anchors are generated once per (canvas,
config) on the host and moved to the device by the detector.

Layout matches the substrate: per level, anchors are ordered row-major over
(H, W) with the A cell anchors innermost, i.e. index = (y*W + x)*A + a.
"""

import math
from typing import List, Sequence, Tuple

import numpy as np


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """[A, 4] zero-centered xyxy anchors for one feature level."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(out, dtype=np.float32)


def grid_anchors(
    feat_hw: Tuple[int, int], stride: int, cell: np.ndarray, offset: float = 0.0
) -> np.ndarray:
    """[H*W*A, 4] anchors for one level on a (H, W) feature grid."""
    h, w = feat_hw
    shifts_x = (np.arange(w, dtype=np.float32) + offset) * stride
    shifts_y = (np.arange(h, dtype=np.float32) + offset) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)  # [H, W]
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # [H*W, 1, 4]
    return (shifts + cell[None, :, :]).reshape(-1, 4)


class AnchorGenerator:
    """Static multi-level anchor generator.

    cfg contract: MODEL.ANCHOR_GENERATOR.{SIZES, ASPECT_RATIOS, OFFSET} with
    broadcasting over levels as in the substrate (one entry = shared).
    """

    def __init__(self, sizes, aspect_ratios, strides, offset=0.0):
        num_levels = len(strides)
        if len(sizes) == 1:
            sizes = list(sizes) * num_levels
        if len(aspect_ratios) == 1:
            aspect_ratios = list(aspect_ratios) * num_levels
        assert len(sizes) == num_levels and len(aspect_ratios) == num_levels
        self.strides = list(strides)
        self.cells = [
            cell_anchors(s, a) for s, a in zip(sizes, aspect_ratios)
        ]
        self.offset = offset
        na = {c.shape[0] for c in self.cells}
        assert len(na) == 1, "all levels must have the same #anchors per cell"
        self.num_cell_anchors = na.pop()

    def __call__(self, feat_hws: List[Tuple[int, int]]) -> List[np.ndarray]:
        """Anchors per level for the given static feature sizes."""
        return [
            grid_anchors(hw, s, c, self.offset)
            for hw, s, c in zip(feat_hws, self.strides, self.cells)
        ]

    @staticmethod
    def from_config(cfg, strides):
        return AnchorGenerator(
            sizes=cfg.MODEL.ANCHOR_GENERATOR.SIZES,
            aspect_ratios=cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS,
            strides=strides,
            offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
        )
