"""Precomputed proposals (``MODEL.LOAD_PROPOSALS``): Fast R-CNN on region
proposals from a file.

Port of ``aldi_tpu/data/proposals.py``: ``load_proposals_into_dataset``
attaches each record's proposals from a detectron2 proposal pickle,
``transform_proposals`` puts them through the gt boxes' geometric steps and
``proposal_files_for`` pairs the files with the datasets. numpy and pickle
only.

- Shapes are static: the proposals are sorted by objectness (stably), cut
  to ``topk`` and padded to exactly ``[topk, 4]`` with a validity mask, so
  the step never sees a data-dependent proposal count.
- The file format is detectron2's: a pickle of ``{"ids": [...], "boxes":
  [per-image [N, 4] XYXY_ABS], "objectness_logits": [per-image [N]]}``,
  with an optional ``bbox_mode`` that must be 0 (XYXY_ABS).
"""

import pickle
from typing import List, Optional, Tuple

import numpy as np


def load_proposals_into_dataset(records: List[dict],
                                proposal_file: str) -> List[dict]:
    """Each record with ``proposal_boxes`` / ``proposal_objectness_logits``
    from a detectron2 proposal pickle. A record whose image_id has no entry
    gets empty arrays (its validity mask is all false downstream). The
    file is unpickled: load only proposal files you trust."""
    with open(proposal_file, "rb") as f:
        data = pickle.load(f)
    if "bbox_mode" in data and int(data["bbox_mode"]) != 0:
        raise ValueError(
            f"proposal file {proposal_file}: only XYXY_ABS boxes (bbox_mode "
            f"0) are supported, got bbox_mode={data['bbox_mode']}")
    by_id = {
        str(i): (np.asarray(b, np.float32), np.asarray(o, np.float32))
        for i, b, o in zip(data["ids"], data["boxes"],
                           data["objectness_logits"])
    }
    empty = (np.zeros((0, 4), np.float32), np.zeros((0,), np.float32))
    out = []
    for r in records:
        boxes, logits = by_id.get(str(r["image_id"]), empty)
        out.append(dict(r, proposal_boxes=boxes,
                        proposal_objectness_logits=logits))
    return out


def transform_proposals(
    boxes: np.ndarray,
    logits: np.ndarray,
    scale: float,
    do_flip: bool,
    out_w: int,
    out_h: int,
    topk: int,
    crop_offset: Optional[Tuple[int, int]] = None,
    crop_wh: Optional[Tuple[int, int]] = None,
    min_box_size: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Original-image XYXY proposals -> padded resized-image arrays
    (boxes [topk, 4], logits [topk], valid [topk]).

    The gt boxes' geometric steps in ``data/transforms.py``: crop shift
    and clip into the crop, scale, flip, clip to the image, drop boxes no
    larger than ``min_box_size``; then the top ``topk`` by objectness (a
    stable sort) padded to ``topk`` rows, padding logits -1e9."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4).copy()
    logits = np.asarray(logits, np.float32).reshape(-1)
    if boxes.shape[0] != logits.shape[0]:
        raise ValueError(f"{boxes.shape[0]} proposal boxes but "
                         f"{logits.shape[0]} objectness logits")

    if crop_offset is not None:
        x0, y0 = crop_offset
        cw, ch = crop_wh
        boxes[:, 0::2] -= x0
        boxes[:, 1::2] -= y0
        # slice views: np.clip(out=) on a fancy-indexed copy would be lost
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
    boxes *= scale
    if do_flip:
        xl = boxes[:, 0].copy()
        boxes[:, 0] = out_w - boxes[:, 2]
        boxes[:, 2] = out_w - xl
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, out_w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, out_h)
    keep = ((boxes[:, 2] - boxes[:, 0] > min_box_size)
            & (boxes[:, 3] - boxes[:, 1] > min_box_size))
    boxes, logits = boxes[keep], logits[keep]

    order = np.argsort(-logits, kind="stable")[:topk]
    boxes, logits = boxes[order], logits[order]

    n = boxes.shape[0]
    out_boxes = np.zeros((topk, 4), np.float32)
    out_logits = np.full((topk,), -1e9, np.float32)
    out_valid = np.zeros((topk,), bool)
    out_boxes[:n] = boxes
    out_logits[:n] = logits
    out_valid[:n] = True
    return out_boxes, out_logits, out_valid


def proposal_files_for(cfg, dataset_names, train: bool) -> List[Optional[str]]:
    """The proposal file of each dataset (or None), in the order of
    ``DATASETS.TRAIN`` / ``DATASETS.TEST`` (detectron2's
    ``get_detection_dataset_dicts(proposal_files=...)``)."""
    files = (cfg.DATASETS.PROPOSAL_FILES_TRAIN if train
             else cfg.DATASETS.PROPOSAL_FILES_TEST)
    if not cfg.MODEL.LOAD_PROPOSALS or not files:
        return [None] * len(dataset_names)
    if len(files) != len(dataset_names):
        which = "TRAIN" if train else "TEST"
        raise ValueError(
            f"PROPOSAL_FILES_{which} must align 1:1 with DATASETS.{which} "
            f"(got {len(files)} files for {len(dataset_names)} datasets)")
    return list(files)
