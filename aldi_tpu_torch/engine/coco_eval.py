"""COCO-protocol mAP computation in pure numpy.

A copy of ``aldi_tpu/engine/coco_eval.py``.

The reference evaluates with pycocotools' COCOeval C extension behind
``COCOEvaluator`` (reference ``aldi/helpers.py:65-81``); that package is not
a dependency here, so the bbox protocol is implemented natively: IoU
thresholds 0.5:0.05:0.95, 101-point interpolated precision, area ranges,
maxDets 100, greedy per-category matching with crowd/ignore handling.

Produces the substrate's metric keys ("bbox/AP", "bbox/AP50", ...) that the
best-checkpointer tracks (reference ``aldi/trainer.py:190-195``).
"""

from collections import defaultdict
from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray
              ) -> np.ndarray:
    """IoU matrix [D, G]; for crowd gt, intersection over det area."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx0, dy0 = dets[:, 0], dets[:, 1]
    dx1, dy1 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx0, gy0 = gts[:, 0], gts[:, 1]
    gx1, gy1 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.clip(
        np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None]),
        0, None,
    )
    iy = np.clip(
        np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None]),
        0, None,
    )
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None], d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / union, 0.0)


def _evaluate_image(dets: List[dict], gts: List[dict], area_rng) -> dict:
    """Greedy matching for one (image, category): COCOeval.evaluateImg."""
    # area-conditioned ignore BEFORE sorting: pycocotools sorts gt by the
    # per-areaRng _ignore (clean in-range gt first), which sets the
    # tie-break order during matching
    def full_ignore(g):
        return bool(
            g.get("_ignore", 0)
            or not (area_rng[0] <= g["area"] <= area_rng[1])
        )

    gts = sorted(gts, key=full_ignore)  # stable: clean gt first
    g_ignore = np.array([full_ignore(g) for g in gts], bool)
    iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts])
    dets = sorted(dets, key=lambda d: -d["score"])[:MAX_DETS]

    d_boxes = np.array([d["bbox"] for d in dets]).reshape(-1, 4)
    g_boxes = np.array([g["bbox"] for g in gts]).reshape(-1, 4)
    ious = _iou_xywh(d_boxes, g_boxes, iscrowd)

    T, D, G = len(IOU_THRS), len(dets), len(gts)
    dt_match = np.zeros((T, D), dtype=np.int64)  # 1 + gt idx, 0 = unmatched
    # greedy per threshold, vectorized over gts: a det matches the best
    # available clean gt above threshold, else the best available ignored gt
    # (crowds stay available); COCOeval.evaluateImg semantics.
    for t, thr in enumerate(IOU_THRS):
        thr = min(thr, 1 - 1e-10)
        taken = np.zeros(G, bool)
        for di in range(D):
            if G == 0:
                break
            clean = ~g_ignore & ~taken
            iou_c = np.where(clean, ious[di], -1.0)
            gi = int(iou_c.argmax()) if G else -1
            if G and iou_c[gi] >= thr:
                dt_match[t, di] = gi + 1
                taken[gi] = True
                continue
            ign = g_ignore & (~taken | iscrowd)
            iou_i = np.where(ign, ious[di], -1.0)
            gi = int(iou_i.argmax()) if G else -1
            if G and iou_i[gi] >= thr:
                dt_match[t, di] = gi + 1
                taken[gi] = True

    # dt ignore: matched to ignored gt, or unmatched + outside area range
    d_area = d_boxes[:, 2] * d_boxes[:, 3]
    out_of_range = ~((d_area >= area_rng[0]) & (d_area <= area_rng[1]))
    matched = dt_match > 0
    g_ign_or_false = np.concatenate([[False], g_ignore])  # index 0 = unmatched
    dt_ignore = np.where(matched, g_ign_or_false[dt_match], out_of_range[None])
    return {
        "scores": np.array([d["score"] for d in dets]),
        "dt_match": dt_match,
        "dt_ignore": dt_ignore,
        "num_gt": int((~g_ignore).sum()),
    }


def evaluate_detections(
    predictions: Dict[int, List[dict]],
    annotations: Dict[int, List[dict]],
    category_ids: List[int],
) -> Dict[str, float]:
    """predictions/annotations: image_id -> list of dicts with XYWH 'bbox',
    'category_id' (+ 'score' for predictions, 'iscrowd'/'area' for gt).
    Returns {"bbox/AP", "bbox/AP50", "bbox/AP75", "bbox/APs", ...}.
    """
    image_ids = sorted(annotations.keys())
    preds_by = defaultdict(list)
    for img_id, dets in predictions.items():
        for d in dets:
            preds_by[(img_id, d["category_id"])].append(d)
    gts_by = defaultdict(list)
    for img_id in image_ids:
        for g in annotations[img_id]:
            g = dict(g)
            # pycocotools _prepare: gt ignored if crowd OR flagged "ignore"
            g["_ignore"] = g.get("iscrowd", 0) or g.get("ignore", 0)
            g.setdefault("area", g["bbox"][2] * g["bbox"][3])
            gts_by[(img_id, g["category_id"])].append(g)

    T, R = len(IOU_THRS), len(REC_THRS)
    ap = {}  # area -> [T, K] AP
    for area_name, area_rng in AREA_RANGES.items():
        ap_tk = np.full((T, len(category_ids)), np.nan)
        for ki, cat in enumerate(category_ids):
            evals = [
                _evaluate_image(
                    preds_by.get((img_id, cat), []),
                    gts_by.get((img_id, cat), []),
                    area_rng,
                )
                for img_id in image_ids
                if preds_by.get((img_id, cat)) or gts_by.get((img_id, cat))
            ]
            if not evals:
                continue
            num_gt = sum(e["num_gt"] for e in evals)
            if num_gt == 0:
                continue
            scores = np.concatenate([e["scores"] for e in evals])
            order = np.argsort(-scores, kind="mergesort")
            dm = np.concatenate([e["dt_match"] for e in evals], axis=1)[:, order]
            di = np.concatenate([e["dt_ignore"] for e in evals], axis=1)[:, order]

            tps = (dm > 0) & ~di
            fps = (dm == 0) & ~di
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            for t in range(T):
                tp, fp = tp_cum[t], fp_cum[t]
                rc = tp / num_gt
                pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                # monotone-decreasing precision envelope
                pr = np.maximum.accumulate(pr[::-1])[::-1]
                if len(pr) == 0:
                    ap_tk[t, ki] = 0.0
                    continue
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.where(
                    inds < len(pr), pr[np.minimum(inds, len(pr) - 1)], 0.0
                )
                ap_tk[t, ki] = q.mean()
        ap[area_name] = ap_tk

    def mean_ap(arr):
        valid = ~np.isnan(arr)
        return float(arr[valid].mean() * 100) if valid.any() else float("nan")

    results = {
        "bbox/AP": mean_ap(ap["all"]),
        "bbox/AP50": mean_ap(ap["all"][0]),
        "bbox/AP75": mean_ap(ap["all"][5]),
        "bbox/APs": mean_ap(ap["small"]),
        "bbox/APm": mean_ap(ap["medium"]),
        "bbox/APl": mean_ap(ap["large"]),
    }
    return results
