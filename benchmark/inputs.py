"""The benchmark's inputs, made on the device from a seed: synthetic scenes
(objects of flat colours on a smooth background), ground-truth boxes and every random draw of a DAOD step, in the layout the
port's ``make_train_step`` takes (a frozen copy of ``draw_step``'s layout for
the R-CNN family, without alignment or precomputed proposals). The program
and the reference are handed the same tensors."""

import math

import torch
import torch.nn.functional as F

from .reference.data.strong_aug import strong_aug_draws
from .reference.ops.matcher import (sample_proposals_draws,
                                    subsample_indices_draws)
from .reference.ops.anchors import AnchorGenerator
from .reference.models.vit import VIT_CONFIGS

VIT_BACKBONES = {"build_vitdet_b_backbone": "b", "build_vitdet_l_backbone": "l"}


def uniform(gen, shape, lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def image_sizes(n, canvas, cut, device):
    """Valid (h, w) of n images: the full canvas, but for image 1, which is
    ``cut`` (dh, dw) px smaller (an image that does not fill the canvas)."""
    sizes = torch.tensor([list(canvas)] * n, dtype=torch.int32)
    if n > 1:
        sizes[1] = torch.tensor([canvas[0] - cut[0], canvas[1] - cut[1]])
    return sizes.to(device)


def scenes(gen, canvas, boxes, valid):
    """Images [n, H, W, 3] float32 in 0..255 with objects at ``boxes``
    [n, K, 4] (where ``valid``): a smooth random background (noise at 1/32
    of the canvas, bilinearly upsampled) under fine noise, and each object
    a flat colour of its own over it, the later ones in front. Their
    structure spreads the detector's responses over the canvas, as a
    photograph's does, where pure noise makes every region alike and every
    ranking of proposals and detections a near-tie."""
    n = boxes.shape[0]
    h, w = canvas
    low = uniform(gen, (n, 3, -(-h // 32), -(-w // 32)), 0.0, 255.0)
    img = F.interpolate(low, size=(h, w), mode="bilinear",
                        align_corners=False).permute(0, 2, 3, 1)
    img = 0.8 * img + uniform(gen, (n, h, w, 3), 0.0, 0.2 * 255.0)
    colors = uniform(gen, (n, boxes.shape[1], 3), 0.0, 255.0)
    ys = torch.arange(h, device=gen.device, dtype=torch.float32)[None, :,
                                                                  None]
    xs = torch.arange(w, device=gen.device, dtype=torch.float32)[None, None]
    for k in range(boxes.shape[1]):
        b = boxes[:, k, :, None, None]
        inside = ((ys >= b[:, 1]) & (ys < b[:, 3]) & (xs >= b[:, 0])
                  & (xs < b[:, 2]) & valid[:, k, None, None])
        img = torch.where(inside[..., None], colors[:, k, None, None], img)
    return img.contiguous()


def gt_boxes(gen, n, max_gt, canvas, num_classes, count, side, cut):
    """``count`` (lo, hi) gt boxes an image of ``side`` (lo, hi) px inside
    the canvas less ``cut`` (so inside every image's valid size), with
    classes, padded to max_gt slots: (boxes [n, max_gt, 4], classes
    [n, max_gt] int32, valid [n, max_gt])."""
    n_min, n_max = count
    side_min, side_max = side
    h, w = canvas[0] - cut[0], canvas[1] - cut[1]
    count = torch.randint(n_min, n_max + 1, (n,), generator=gen,
                          device=gen.device)
    bw = uniform(gen, (n, max_gt), side_min, side_max)
    bh = uniform(gen, (n, max_gt), side_min, side_max)
    x0 = uniform(gen, (n, max_gt)) * (w - bw)
    y0 = uniform(gen, (n, max_gt)) * (h - bh)
    boxes = torch.stack([x0, y0, x0 + bw, y0 + bh], -1)
    valid = torch.arange(max_gt, device=gen.device)[None] < count[:, None]
    classes = (uniform(gen, (n, max_gt)) * num_classes).to(torch.int32)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return boxes.contiguous(), torch.where(valid, classes, 0), valid


def daod_batch(gen, w, canvas, max_gt, num_classes):
    """One DAOD batch of the workload ``w``: ``n_labeled`` scenes with
    their gt (``gt_count`` objects an image, of ``gt_side`` px), and
    ``n_unlabeled`` scenes with objects alike but no labels; one image of
    each ``cut`` smaller."""
    n_l, n_u, cut = w["n_labeled"], w["n_unlabeled"], w["cut"]
    boxes, classes, valid = gt_boxes(gen, n_l, max_gt, canvas, num_classes,
                                     w["gt_count"], w["gt_side"], cut)
    u_boxes, _, u_valid = gt_boxes(gen, n_u, max_gt, canvas, num_classes,
                                   w["gt_count"], w["gt_side"], cut)
    return {"labeled": {"image": scenes(gen, canvas, boxes, valid),
                        "sizes": image_sizes(n_l, canvas, cut, gen.device),
                        "boxes": boxes, "classes": classes, "valid": valid},
            "unlabeled": {"image": scenes(gen, canvas, u_boxes, u_valid),
                          "sizes": image_sizes(n_u, canvas, cut,
                                               gen.device)}}


def num_anchors(cfg, canvas) -> int:
    """The RPN's anchors on the canvas, over p2..p6."""
    strides = [4, 8, 16, 32, 64]
    gen = AnchorGenerator.from_config(cfg, strides)
    return gen.num_cell_anchors * sum(
        math.ceil(canvas[0] / s) * math.ceil(canvas[1] / s) for s in strides)


def keep_rates(cfg):
    """A ViT trunk's drop-path keep rates [2, depth], or None."""
    size = VIT_BACKBONES.get(cfg.MODEL.BACKBONE.NAME)
    if size is None:
        return None
    v = VIT_CONFIGS[size]
    rates = [1.0 - v["drop_path_rate"] * i / max(v["depth"] - 1, 1)
             for i in range(v["depth"])]
    return torch.tensor(rates).expand(2, -1)


def daod_draws(gen, cfg, canvas, n_labeled, n_unlabeled):
    """Every draw of one ALDI++ step of an R-CNN config whose streams are
    labeled_strong and the distill stream (soft distillation with the
    teacher's anchors), in ``draw_step``'s order and layout; with
    TPU.GRAD_ACCUM = k > 1 each stream's entry is a list of k chunks'."""
    accum = max(int(cfg.TPU.GRAD_ACCUM), 1)
    aug = cfg.AUG
    rpn = cfg.MODEL.RPN
    n_anchors = num_anchors(cfg, canvas)
    k_rpn = min(rpn.BATCH_SIZE_PER_IMAGE, n_anchors)
    n_cand = rpn.POST_NMS_TOPK_TRAIN + (
        cfg.TPU.MAX_GT if cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT else 0)
    keep = keep_rates(cfg)
    if keep is not None:
        keep = keep.to(gen.device)

    def anchors(b):
        return subsample_indices_draws(gen, (b,), n_anchors, k_rpn,
                                       rpn.POSITIVE_FRACTION)

    def chunk(b):
        out = {"rpn": anchors(b), "roi": sample_proposals_draws(gen, (b,),
                                                                n_cand)}
        if keep is not None:
            out["drop"] = uniform(gen, keep.shape + (b,)) < keep[..., None]
        return out

    def student(b):
        return chunk(b) if accum == 1 else [chunk(b // accum)
                                            for _ in range(accum)]

    out = {"strong": student(n_labeled)}
    out["aug_labeled"] = strong_aug_draws(
        gen, n_labeled, canvas, aug.LABELED_INCLUDE_RANDOM_ERASING,
        aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
    out["teacher"] = anchors(n_unlabeled)
    out["distill"] = student(n_unlabeled)
    out["aug_unlabeled"] = strong_aug_draws(
        gen, n_unlabeled, canvas, aug.UNLABELED_INCLUDE_RANDOM_ERASING,
        aug.UNLABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
    return out


def request(gen, w, canvas):
    """One serving request of the workload ``w``: ``request_images``
    scenes [n, H, W, 3] float32 with ``gt_count`` objects of ``gt_side``
    px each, and their valid sizes [n, 2] int32, one of them ``cut``
    smaller."""
    n, cut = w["request_images"], w["cut"]
    count = w["gt_count"]
    boxes, _, valid = gt_boxes(gen, n, count[1], canvas, 1, count,
                               w["gt_side"], cut)
    return (scenes(gen, canvas, boxes, valid),
            image_sizes(n, canvas, cut, gen.device))
