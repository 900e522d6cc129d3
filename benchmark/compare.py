"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to a limit of its cell (``limits`` in
``workloads/<cell>.json``). Every reading is computed and printed; a cell
holds those that separate its sound runs from its control or a planted
fault (PERF.md gives the readings each limit was set from).

Training, over the first steps of the one state: the total loss of each
step (``loss_gap``, the largest relative gap); the norm of each trainable
leaf's gradient of the first step as the optimizer took it
(``grad_gap_*``); the norm of each leaf's change over the steps, of the
student (``change_gap_*``) and of the EMA teacher (``teacher_change_gap_*``).
A leaf's gap is the gap between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever is
larger; ``_p90`` is the leaves' 90th percentile, ``_worst`` the largest.
Leaves whose reference gradient is under a thousandth of the median leaf's
(moved by round-off alone, as a key's bias under softmax) are left out of
the changes. The teacher's pseudo-labels: ``teacher_score_gap``, the mean
gap between the program's and the reference's detection scores of the
teacher pass, rank by rank within each unlabeled image of each step (scores
sorted, so that near-equal detections that bfloat16 reorders read alike; a
missing image or detection reads as score 0); detection by detection, each
of the reference's teacher detections met by the program's detection of its
class that overlaps it most, at IoU ``TEACHER_IOU`` or more: the median gap
of their scores (``matched_score_gap``) and of their boxes, as 1 - IoU
(``matched_box_gap``), both 1 where none is met, and the share met
(``matched_share``); and ``pseudo_count_gap``, the relative gap of the
pseudo-labels counted over the steps.

Serving, over every image of the sampled requests:
- ``score_off_share``: each served detection's score against the
  reference's score of its class from the proposal that the reference's
  own regression carries onto the served box (``reference/runner.py``
  ``rescore``), for every served box that clipping left as decoded and
  whose proposal is off a pyramid level's boundary; the share off by more
  than ``SCORE_TOLERANCE``, and 1 where no detection could be read;
- ``count_gap``: the largest gap of an image's count of detections from the
  reference's own detections', over the reference's count;
- ``miss_share``: the share of the reference's own best ``RANKED``
  detections of each image with no served detection of their class at IoU
  ``MATCH_IOU`` or more (the best three quarters of the top 100: near the
  cut, where scores lie close together, bfloat16 keeps other detections
  than float32);
- ``duplicate_share``: the share of served detections that overlap a
  higher-scored served detection of their class by more than the NMS
  threshold (which per-class NMS rules out);
- ``profile_gap``: as ``teacher_score_gap``, over the served images."""

import statistics

from .harness import quantile


def leaf_gaps(prog: dict, ref: dict, names) -> list:
    floor = statistics.median(ref.values())
    return sorted(abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names)


def score_profile_gap(prog: list, ref: list) -> float:
    """Mean gap of the scores rank by rank: ``prog``/``ref`` are lists (one
    per pass) of [B, D] scores sorted in each row (0 where not valid); rows
    or ranks that one side lacks read as 0."""
    import torch

    total, count = 0.0, 0
    for p, r in zip(prog, ref):
        rows, cols = max(p.shape[0], r.shape[0]), max(p.shape[1], r.shape[1])
        a = torch.zeros(rows, cols)
        b = torch.zeros(rows, cols)
        a[:p.shape[0], :p.shape[1]] = p.float()
        b[:r.shape[0], :r.shape[1]] = r.float()
        total += float((a - b).abs().sum())
        count += rows * cols
    return total / max(count, 1)


def sorted_scores(scores, valid):
    """[B, D] scores of the valid detections, sorted in each row, 0 where
    not valid, on the CPU."""
    s = scores.float().where(valid, scores.new_zeros(()).float())
    return s.sort(dim=-1, descending=True).values.cpu()


def train_readings(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"loss": [...], "grad": {leaf: norm},
    "change": {leaf: norm}, "teacher_change": {leaf: norm},
    "teacher_scores": [[B, D], ...], "teacher_dets": [{boxes, scores,
    classes, valid}, ...], "pseudo": [count, ...]}."""
    loss = max(abs(p - r) / max(abs(r), 1e-12)
               for p, r in zip(prog["loss"], ref["loss"]))
    floor = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= 1e-3 * floor]
    grad = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    change = leaf_gaps(prog["change"], ref["change"], moving)
    teacher = leaf_gaps(prog["teacher_change"], ref["teacher_change"],
                        moving)
    n_ref = sum(ref["pseudo"])
    matched = teacher_matches(prog["teacher_dets"], ref["teacher_dets"])
    return {**matched, "loss_gap": loss,
            "grad_gap_p90": quantile(grad, 0.9), "grad_gap_worst": grad[-1],
            "change_gap_p90": quantile(change, 0.9),
            "change_gap_worst": change[-1],
            "teacher_change_gap_p90": quantile(teacher, 0.9),
            "teacher_change_gap_worst": teacher[-1],
            "teacher_score_gap": score_profile_gap(prog["teacher_scores"],
                                                   ref["teacher_scores"]),
            "pseudo_count_gap": abs(sum(prog["pseudo"]) - n_ref)
            / max(n_ref, 1)}


def _iou(a, b):
    import torch

    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])

    union = area(a)[:, None] + area(b)[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _image(out, i):
    v = out["valid"][i]
    return {k: out[k][i][v].float() if k != "classes" else out[k][i][v]
            for k in ("boxes", "scores", "classes")}


def inside(boxes, sizes, margin=1.0):
    """Boxes [B, D, 4] that keep ``margin`` px from their image's border
    (sizes [B, 2] as (h, w)): clipping left them as decoded."""
    h = sizes[:, 0, None].float()
    w = sizes[:, 1, None].float()
    return ((boxes[..., 0] >= margin) & (boxes[..., 1] >= margin)
            & (boxes[..., 2] <= w - margin) & (boxes[..., 3] <= h - margin))


LEVEL_MARGIN = 0.01  # log2 units: 0.7% of a side, ten times the proposal's error
SCORE_TOLERANCE = 0.05  # twice the widest gap of sound runs but a rare few
RANKED = 75  # the reference's best of an image, inside its top 100
MATCH_IOU = 0.5
DUPLICATE_MARGIN = 1e-3  # IoU over the NMS threshold that rounding cannot make
TEACHER_IOU = 0.9  # the same detection: bfloat16 moves a box by 1 - IoU ~ 0.003


def teacher_matches(prog: list, ref: list) -> dict:
    """The reference's teacher detections met by the program's: ``prog``
    and ``ref`` are lists (one per pass) of dicts of boxes [B, D, 4],
    scores, classes and valid, on the CPU; an image that the program lacks
    meets none. Each reference detection takes the program's detection of
    its class that overlaps it most, and is met at IoU ``TEACHER_IOU`` or
    more. Returns the median score gap and box gap (1 - IoU) of the met
    detections, each 1 where none is met, and the share met."""
    import torch

    score_gaps, box_gaps, total = [], [], 0
    for p, r in zip(prog, ref):
        for i in range(r["valid"].shape[0]):
            b = _image(r, i)
            total += len(b["scores"])
            if i >= p["valid"].shape[0] or not len(b["scores"]):
                continue
            a = _image(p, i)
            if not len(a["scores"]):
                continue
            iou = _iou(b["boxes"], a["boxes"]) * (
                b["classes"][:, None] == a["classes"][None, :])
            best, j = iou.max(1)
            met = best >= TEACHER_IOU
            score_gaps.append((a["scores"][j] - b["scores"]).abs()[met])
            box_gaps.append((1 - best)[met])
    score = torch.cat(score_gaps).tolist() if score_gaps else []
    box = torch.cat(box_gaps).tolist() if box_gaps else []
    return {"matched_score_gap": quantile(score, 0.5) if score else 1.0,
            "matched_box_gap": quantile(box, 0.5) if box else 1.0,
            "matched_share": len(score) / max(total, 1)}


def detection_set(prog: dict, ref: dict, nms_thresh: float) -> dict:
    """Counts of one request's served detections ``prog`` against the
    reference's own ``ref`` (both boxes [B, D, 4], scores, classes, valid,
    on the CPU): the worst image's count gap, the reference's best
    detections and how many of them the served answer misses, the served
    detections and how many duplicate one of their class (an equal score
    counts the earlier one as the higher)."""
    import torch

    count_gap, best, missed, served, dup = 0.0, 0, 0, 0, 0
    for i in range(ref["valid"].shape[0]):
        p = _image(prog, i) if i < prog["valid"].shape[0] else None
        r = _image(ref, i)
        n_p = 0 if p is None else len(p["scores"])
        count_gap = max(count_gap, abs(n_p - len(r["scores"]))
                        / max(len(r["scores"]), 1))
        keep = r["scores"].argsort(descending=True)[:RANKED]
        best += len(keep)
        if not n_p:
            missed += len(keep)
            continue
        iou = _iou(r["boxes"][keep], p["boxes"])
        same = r["classes"][keep][:, None] == p["classes"][None, :]
        missed += int((~((iou >= MATCH_IOU) & same).any(1)).sum())
        served += n_p
        own = _iou(p["boxes"], p["boxes"])
        j = torch.arange(n_p)
        higher = ((p["scores"][None, :] > p["scores"][:, None])
                  | ((p["scores"][None, :] == p["scores"][:, None])
                     & (j[None, :] < j[:, None])))
        same = p["classes"][:, None] == p["classes"][None, :]
        dup += int(((own > nms_thresh + DUPLICATE_MARGIN) & higher & same)
                   .any(1).sum())
    return {"count_gap": count_gap, "best": best,
            "missed": missed, "served": served, "duplicates": dup}


def serve_readings(prog: dict, rescored, margin, sizes) -> dict:
    """``prog``: one request's served detections (boxes [B, D, 4], scores,
    classes, valid); ``rescored`` [B, D]: the reference's score of each
    served detection, ``margin`` [B, D] its proposal's distance from a
    pyramid level's boundary; ``sizes`` [B, 2]: the images' valid sizes.
    All on the CPU. A score is read where the served box was not clipped to
    its image (a clipped box does not say which proposal it came from) and
    its proposal is not on a level boundary (the found proposal is the
    served one to about 0.1%, and on a boundary that decides between two
    levels' features). Returns the detections read, those off by more
    than ``SCORE_TOLERANCE``, and the widest gap."""
    v = (prog["valid"] & inside(prog["boxes"], sizes)
         & (margin >= LEVEL_MARGIN))
    gap = (prog["scores"].float() - rescored.float()).abs()[v]
    return {"read": int(v.sum()), "off": int((gap > SCORE_TOLERANCE).sum()),
            "score_gap": float(gap.max()) if gap.numel() else 0.0}


def judge(readings: dict, limits: dict):
    """(correct, [[name, reading, limit], ...]): correct when every
    reading is at or under its limit and finite."""
    rows = [[k, readings[k], limits[k]] for k in sorted(limits)]
    ok = all(r == r and r <= lim for _, r, lim in rows)
    return ok, rows
