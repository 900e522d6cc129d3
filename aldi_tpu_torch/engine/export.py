"""Serving entry point: the detector's inference path closed over weights.

Port of ``make_serving_fn`` (``aldi_tpu/engine/export.py:43-58``), with the
same calling convention and without the StableHLO export.
"""

import torch

__all__ = ["make_serving_fn"]


def make_serving_fn(det, weights=None):
    """Load ``weights`` (a state dict, or None to keep the detector's own)
    and return ``fn(images [B,H,W,3] f32 in 0..255, sizes [B,2] i32) ->
    dict`` with boxes [B,N,4] xyxy on the canvas, scores [B,N], classes
    [B,N] int32 and valid [B,N] bool. Inputs may be numpy arrays or tensors
    on any device; outputs stay on the detector's device."""
    if weights is not None:
        det.module.load_state_dict(weights)

    def fn(images, sizes):
        images = torch.as_tensor(images, dtype=torch.float32, device=det.device)
        sizes = torch.as_tensor(sizes, dtype=torch.int32, device=det.device)
        boxes, scores, classes, valid = det.forward_inference(images, sizes)
        return {"boxes": boxes, "scores": scores, "classes": classes,
                "valid": valid}

    return fn
