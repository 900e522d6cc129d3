"""Box geometry ops: area, IoU, clipping, delta encode/decode.

Port of ``aldi_tpu/ops/boxes.py``. All functions are shape-polymorphic over
leading dims. Boxes are XYXY absolute pixel coordinates.
"""

import math

import torch

# Clamp on predicted dw/dh, matching the reference substrate's
# Box2BoxTransform scale clamp of log(1000/16).
_SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix between [..., N, 4] and [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, hw) -> torch.Tensor:
    """Clip [..., 4] boxes to [0, w] x [0, h]. ``hw`` is (h, w), scalars or
    tensors broadcastable against the leading dims."""
    h, w = (torch.as_tensor(v, dtype=boxes.dtype, device=boxes.device)
            for v in hw)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y0 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x1 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & (
        (boxes[..., 3] - boxes[..., 1]) > threshold
    )


def encode_deltas(src: torch.Tensor, target: torch.Tensor,
                  weights) -> torch.Tensor:
    """(dx, dy, dw, dh) deltas transforming ``src`` boxes into ``target``
    boxes (Box2BoxTransform.get_deltas); ``weights`` is (wx, wy, ww, wh)."""
    wx, wy, ww, wh = weights
    src_w = src[..., 2] - src[..., 0]
    src_h = src[..., 3] - src[..., 1]
    src_cx = src[..., 0] + 0.5 * src_w
    src_cy = src[..., 1] + 0.5 * src_h
    tgt_w = target[..., 2] - target[..., 0]
    tgt_h = target[..., 3] - target[..., 1]
    tgt_cx = target[..., 0] + 0.5 * tgt_w
    tgt_cy = target[..., 1] + 0.5 * tgt_h
    # guard padding boxes (zero size) against division by zero / log(0)
    one = torch.ones((), dtype=src.dtype, device=src.device)
    safe_w = torch.where(src_w > 0, src_w, one)
    safe_h = torch.where(src_h > 0, src_h, one)
    dx = wx * (tgt_cx - src_cx) / safe_w
    dy = wy * (tgt_cy - src_cy) / safe_h
    dw = ww * torch.log(tgt_w.clamp(min=1e-6) / safe_w)
    dh = wh * torch.log(tgt_h.clamp(min=1e-6) / safe_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                  weights) -> torch.Tensor:
    """Apply (dx, dy, dw, dh) deltas to boxes (Box2BoxTransform.apply_deltas).

    ``deltas`` is [..., 4] or [..., K*4] paired with [..., 4] boxes; in the
    latter case the output is [..., K*4].
    """
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights

    shape = deltas.shape
    d = deltas.reshape(shape[:-1] + (-1, 4))
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=_SCALE_CLAMP)
    dh = (d[..., 3] / wh).clamp(max=_SCALE_CLAMP)

    pred_cx = dx * widths[..., None] + cx[..., None]
    pred_cy = dy * heights[..., None] + cy[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [
            pred_cx - 0.5 * pred_w,
            pred_cy - 0.5 * pred_h,
            pred_cx + 0.5 * pred_w,
            pred_cy + 0.5 * pred_h,
        ],
        dim=-1,
    )
    return out.reshape(shape)
