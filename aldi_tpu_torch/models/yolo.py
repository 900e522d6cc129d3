"""YOLOv5 detector family: architecture, assigner and loss, DAOD interface.

Port of ``aldi_tpu/models/yolo.py``. ``YOLOv5`` holds the weights under the
JAX package's module names (``b0..b9`` backbone, ``n10..n23`` neck,
``detect0..2`` heads; ``cv1/cv2/cv3``, ``m{i}``, ``conv``, ``bn`` inside),
so both weight converters (``engine/checkpoint_convert.py``) are joins of
names. Convolutions run in the compute dtype on NCHW tensors in
``channels_last`` memory format, as the R-CNN trunks do.

``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.97, epsilon=1e-3,
dtype=float32)`` (``aldi_tpu/models/yolo.py:74-77``), not
``torch.nn.BatchNorm2d``: statistics in float32 over N, H, W with
``E[x^2] - E[x]^2``, the running variance updated with the *biased* batch
variance, and no ``num_batches_tracked`` (the EMA teacher blends every
floating-point buffer). The running statistics are the module's buffers; a
forward in training mode normalizes by the batch statistics and updates
them, one in eval mode normalizes by them.

``YoloDetector`` follows the contract of ``RCNNDetector``
(``models/rcnn.py``). The mode of each call is part of its semantics: the
student's streams and the target_weak stream run the module in training
mode (the running statistics move, ``:515-523``), the teacher,
``forward_inference`` and ``detect`` in eval mode; every call restores the
module's mode on return. The JAX package's ``lax.map`` over images is a
batch dimension here.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..config import compute_dtype, resolve_canvas
from ..ops.boxes import clip_boxes
from ..ops.losses import bce_with_logits, softmax_cross_entropy
from ..ops.nms import batched_nms_keep_mask, top_k
from ..parallel.mesh import (batch_mean, data_world, global_batch,
                             global_count)
from .layers import DenseConv2d
from .rcnn import ConvDiscriminator, grad_reverse

# (depth_multiple, width_multiple) per variant, from the upstream model yamls
MULTIPLES = {
    "yolov5n": (0.33, 0.25),
    "yolov5s": (0.33, 0.50),
    "yolov5m": (0.67, 0.75),
    "yolov5l": (1.00, 1.00),
    "yolov5x": (1.33, 1.25),
}
ANCHORS = (  # pixels, per level P3/P4/P5
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)
BALANCE = (4.0, 1.0, 0.4)  # per-level objectness weights
ALIGN_LEVELS = {"p3": 0, "p4": 1, "p5": 2}
TOPK_CANDIDATES = 2000  # candidates per image into NMS


def _gd(n, depth_mult):
    return max(round(n * depth_mult), 1)


def _gw(c, width_mult):
    return int(math.ceil(c * width_mult / 8) * 8)


class _BatchNormTrain(torch.autograd.Function):
    """flax's training-mode BatchNorm over the channels of NCHW ``x``:
    float32 batch statistics (``var = max(E[x^2] - E[x]^2, 0)``), ``y =
    (x - mean) * (rsqrt(var + eps) * weight) + bias`` cast to ``x``'s
    dtype. Returns (y, mean, var); the backward is the batch-statistics
    gradient in float32, keeping only ``x`` for it.

    Under data parallelism the statistics are the global batch's, as
    under the JAX package's sharded mesh (sync-BN): the forward all-reduces
    the per-channel sum, sum of squares and count, the backward its two
    per-channel sums (of dy and dy * xhat). The weight's and the bias's
    gradients stay the rank's own sums: the step's gradient all-reduce
    adds them up. Every rank runs the same BatchNorms in the same order,
    so the collectives pair up."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = (0, 2, 3)
        xf = x.float()
        c = x.shape[1]
        if data_world() == 1:
            n = x.numel() // c
            mean = xf.mean(dims)
            var = (xf.square().mean(dims) - mean.square()).clamp(min=0.0)
        else:
            stats = global_count(torch.cat([
                xf.sum(dims), xf.square().sum(dims),
                xf.new_full((1,), x.numel() // c)]))
            n = stats[-1]
            mean = stats[:c] / n
            var = (stats[c:2 * c] / n - mean.square()).clamp(min=0.0)
        mul = torch.rsqrt(var + eps) * weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + bias[:, None, None]).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, var)
        ctx.eps, ctx.n = eps, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, var = ctx.saved_tensors
        dims = (0, 2, 3)
        n = ctx.n
        g = gy.float()
        invstd = torch.rsqrt(var + ctx.eps)
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        gbias = g.sum(dims)
        gweight = (g * xhat).sum(dims)
        sums_b, sums_w = gbias, gweight
        if data_world() > 1:
            sums_b, sums_w = global_count(
                torch.cat([gbias, gweight])).split(x.shape[1])
        gx = (weight * invstd)[:, None, None] * (
            g - (sums_b / n)[:, None, None]
            - xhat * (sums_w / n)[:, None, None])
        return gx.to(x.dtype), gweight, gbias, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype=float32)`` over the
    channels of an NCHW tensor; the output is cast back to the input's
    dtype (the JAX layer's ``.astype(self.dtype)``)."""

    def __init__(self, num_features, momentum=0.97, eps=1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias,
                                             self.eps)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)


class ConvBnSiLU(nn.Module):
    def __init__(self, cin, cout, k=1, s=1, p=-1, dtype=torch.float32):
        super().__init__()
        p = k // 2 if p < 0 else p  # the 6x6 stem passes 2 explicitly
        self.conv = DenseConv2d(cin, cout, k, stride=s, padding=p, bias=False,
                                compute_dtype=dtype)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c, shortcut=True, dtype=torch.float32):
        super().__init__()
        self.cv1 = ConvBnSiLU(c, c, 1, dtype=dtype)
        self.cv2 = ConvBnSiLU(c, c, 3, dtype=dtype)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C3(nn.Module):
    def __init__(self, cin, cout, n=1, shortcut=True, dtype=torch.float32):
        super().__init__()
        h = cout // 2
        self.cv1 = ConvBnSiLU(cin, h, 1, dtype=dtype)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(h, shortcut, dtype))
        self.cv2 = ConvBnSiLU(cin, h, 1, dtype=dtype)
        self.cv3 = ConvBnSiLU(2 * h, cout, 1, dtype=dtype)

    def forward(self, x):
        a = self.cv1(x)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, cin, cout, k=5, dtype=torch.float32):
        super().__init__()
        h = cin // 2
        self.cv1 = ConvBnSiLU(cin, h, 1, dtype=dtype)
        self.cv2 = ConvBnSiLU(4 * h, cout, 1, dtype=dtype)
        self.k = k

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], 1))


def _upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YOLOv5(nn.Module):
    """CSP backbone + PANet neck + Detect head (and, with image-level
    alignment, the discriminator ``img_align`` on the neck level
    ``align_level``). ``forward(x)`` on normalized NCHW images returns the
    per-level raw predictions [B, H_l, W_l, A, 5 + nc] in float32 (xywh |
    obj | cls) and the neck outputs (p3, p4, p5), NCHW."""

    def __init__(self, num_classes, depth_mult=0.67, width_mult=0.75,
                 dtype=torch.float32, align_level=None):
        super().__init__()
        gw = lambda c: _gw(c, width_mult)  # noqa: E731
        gd = lambda n: _gd(n, depth_mult)  # noqa: E731
        dt = dtype
        self.num_classes, self.width_mult = num_classes, width_mult
        self.b0 = ConvBnSiLU(3, gw(64), 6, 2, 2, dt)  # P1/2
        self.b1 = ConvBnSiLU(gw(64), gw(128), 3, 2, -1, dt)  # P2/4
        self.b2 = C3(gw(128), gw(128), gd(3), True, dt)
        self.b3 = ConvBnSiLU(gw(128), gw(256), 3, 2, -1, dt)  # P3/8
        self.b4 = C3(gw(256), gw(256), gd(6), True, dt)
        self.b5 = ConvBnSiLU(gw(256), gw(512), 3, 2, -1, dt)  # P4/16
        self.b6 = C3(gw(512), gw(512), gd(9), True, dt)
        self.b7 = ConvBnSiLU(gw(512), gw(1024), 3, 2, -1, dt)  # P5/32
        self.b8 = C3(gw(1024), gw(1024), gd(3), True, dt)
        self.b9 = SPPF(gw(1024), gw(1024), 5, dt)
        self.n10 = ConvBnSiLU(gw(1024), gw(512), 1, 1, -1, dt)
        self.n13 = C3(2 * gw(512), gw(512), gd(3), False, dt)
        self.n14 = ConvBnSiLU(gw(512), gw(256), 1, 1, -1, dt)
        self.n17 = C3(2 * gw(256), gw(256), gd(3), False, dt)  # P3 out
        self.n18 = ConvBnSiLU(gw(256), gw(256), 3, 2, -1, dt)
        self.n20 = C3(2 * gw(256), gw(512), gd(3), False, dt)  # P4 out
        self.n21 = ConvBnSiLU(gw(512), gw(512), 3, 2, -1, dt)
        self.n23 = C3(2 * gw(512), gw(1024), gd(3), False, dt)  # P5 out
        self.num_anchors = len(ANCHORS[0])
        no = 5 + num_classes
        for i, c in enumerate((gw(256), gw(512), gw(1024))):
            self.add_module(f"detect{i}", DenseConv2d(
                c, self.num_anchors * no, 1, compute_dtype=dt))
        if align_level is not None:
            channels = (gw(256), gw(512), gw(1024))[ALIGN_LEVELS[align_level]]
            self.img_align = ConvDiscriminator(channels, (256,), dt)

    def forward(self, x):
        x = self.b2(self.b1(self.b0(x)))
        c4 = self.b4(self.b3(x))
        c6 = self.b6(self.b5(c4))
        x = self.b9(self.b8(self.b7(c6)))

        p5_in = self.n10(x)
        n13 = self.n13(torch.cat([_upsample2x(p5_in), c6], 1))
        p4_in = self.n14(n13)
        p3 = self.n17(torch.cat([_upsample2x(p4_in), c4], 1))
        p4 = self.n20(torch.cat([self.n18(p3), p4_in], 1))
        p5 = self.n23(torch.cat([self.n21(p4), p5_in], 1))

        outs = []
        for i, f in enumerate((p3, p4, p5)):
            y = getattr(self, f"detect{i}")(f).permute(0, 2, 3, 1)
            b, h, w, _ = y.shape
            outs.append(y.reshape(b, h, w, self.num_anchors, -1).float())
        return outs, (p3, p4, p5)


# ------------------------------------------------------------------ assigner
def build_targets(gt_boxes, gt_classes, gt_valid, feat_hws,
                  anchor_t: float = 4.0):
    """v5 ``build_targets`` over a fixed candidate lattice: per level, per
    gt, per anchor, the center cell and its x- and y-neighbor. gt_boxes
    [B, G, 4] xyxy canvas pixels, gt_classes and gt_valid [B, G]. Returns
    per level a dict of [B, G, A, 3] tensors: the cells ``ci``/``cj``,
    ``valid``, ``classes``, and [B, G, A, 3, 2] ``txy`` (the gt center's
    offset from the cell), ``twh`` (gt size) and ``anchors``, in grid
    units."""
    cxcywh = torch.stack([
        (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2,
        (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2,
        gt_boxes[..., 2] - gt_boxes[..., 0],
        gt_boxes[..., 3] - gt_boxes[..., 1]], -1)
    dev = gt_boxes.device
    out = []
    for stride, anchors, (fh, fw) in zip(STRIDES, ANCHORS, feat_hws):
        g = cxcywh / stride  # grid units
        anc = torch.tensor(anchors, dtype=torch.float32, device=dev) / stride
        r = g[..., None, 2:4] / anc  # [B, G, A, 2]
        ratio = torch.maximum(r, 1.0 / r.clamp(min=1e-9)).amax(-1)
        match = (ratio < anchor_t) & gt_valid[..., None]  # [B, G, A]

        gx, gy = g[..., 0], g[..., 1]
        fx, fy = torch.remainder(gx, 1.0), torch.remainder(gy, 1.0)
        cx, cy = torch.floor(gx), torch.floor(gy)
        x_off = torch.where(fx < 0.5, -1.0, 1.0)
        x_ok = torch.where(fx < 0.5, gx > 1.0, gx < fw - 1.0)
        y_off = torch.where(fy < 0.5, -1.0, 1.0)
        y_ok = torch.where(fy < 0.5, gy > 1.0, gy < fh - 1.0)
        cand_cx = torch.stack([cx, cx + x_off, cx], -1)  # [B, G, 3]
        cand_cy = torch.stack([cy, cy, cy + y_off], -1)
        cand_ok = torch.stack([torch.ones_like(x_ok), x_ok, y_ok], -1)

        ci = cand_cx.clamp(0, fw - 1).long()
        cj = cand_cy.clamp(0, fh - 1).long()
        valid = match[..., :, None] & cand_ok[..., None, :]  # [B, G, A, 3]
        shape = valid.shape
        txy = (g[..., None, None, 0:2]
               - torch.stack([cand_cx, cand_cy], -1)[..., None, :, :])
        out.append({
            "ci": ci[..., None, :].expand(shape),
            "cj": cj[..., None, :].expand(shape),
            "valid": valid,
            "txy": txy.expand(shape + (2,)),
            "twh": g[..., None, None, 2:4].expand(shape + (2,)),
            "anchors": anc[:, None, :].expand(shape + (2,)),
            "classes": gt_classes[..., None, None].expand(shape),
        })
    return out


def ciou(box1, box2, eps=1e-7):
    """Complete IoU between paired cxcywh boxes [..., 4] (v5 bbox_iou);
    its ``alpha`` carries no gradient."""
    b1x, b1y, b1w, b1h = box1.unbind(-1)
    b2x, b2y, b2w, b2h = box2.unbind(-1)
    b1x0, b1x1 = b1x - b1w / 2, b1x + b1w / 2
    b1y0, b1y1 = b1y - b1h / 2, b1y + b1h / 2
    b2x0, b2x1 = b2x - b2w / 2, b2x + b2w / 2
    b2y0, b2y1 = b2y - b2h / 2, b2y + b2h / 2
    iw = (torch.minimum(b1x1, b2x1) - torch.maximum(b1x0, b2x0)).clamp(min=0)
    ih = (torch.minimum(b1y1, b2y1) - torch.maximum(b1y0, b2y0)).clamp(min=0)
    inter = iw * ih
    union = b1w * b1h + b2w * b2h - inter + eps
    iou = inter / union
    cw = torch.maximum(b1x1, b2x1) - torch.minimum(b1x0, b2x0)
    ch = torch.maximum(b1y1, b2y1) - torch.minimum(b1y0, b2y0)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (b2x - b1x) ** 2 + (b2y - b1y) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(b2w / b2h.clamp(min=eps))
                              - torch.atan(b1w / b1h.clamp(min=eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _gather_cells(pi, t):
    """The predictions [B, G, A, 3, no] of level ``pi`` [B, H, W, A, no] at
    the candidate cells of ``t``, and the flat (cell, anchor) index
    [B, G, A, 3] into its [B*H*W*A] grid."""
    b, h, w, na, no = pi.shape
    shape = t["valid"].shape
    bi = torch.arange(b, device=pi.device)[:, None, None, None].expand(shape)
    ai = torch.arange(na, device=pi.device)[None, None, :, None].expand(shape)
    cell = (bi * h + t["cj"]) * w + t["ci"]
    return pi.reshape(b * h * w, na, no)[cell, ai], cell * na + ai


def _one_hot(classes, num_classes):
    """``jax.nn.one_hot``: out-of-range ids give all-zero rows."""
    return (classes[..., None] == torch.arange(
        num_classes, device=classes.device)).float()


def yolo_losses(preds, targets, num_classes, box_gain, obj_gain, cls_gain,
                label_smoothing=0.0):
    """v5 ComputeLoss over the dense candidate lattice: CIoU box loss over
    the valid candidates, objectness BCE against the detached, clipped IoU
    scatter-maxed into the dense grid (duplicate (cell, anchor) candidates
    keep their largest IoU), per-level ``BALANCE``, and one-hot BCE
    classification when there is more than one class. The candidates'
    counts are the global batch's (``global_count``, an all-reduce:
    every rank makes the call, in the same order, ``parallel/mesh.py``)."""
    dev = preds[0].device
    lbox = lobj = lcls = torch.zeros((), device=dev)
    cp, cn = 1.0 - 0.5 * label_smoothing, 0.5 * label_smoothing
    for pi, t, bal in zip(preds, targets, BALANCE):
        ps, flat = _gather_cells(pi, t)
        pxy = torch.sigmoid(ps[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2 * t["anchors"]
        iou = ciou(torch.cat([pxy, pwh], -1),
                   torch.cat([t["txy"], t["twh"]], -1))
        vf = t["valid"].float()
        lbox = lbox + ((1.0 - iou) * vf).sum() / global_count(
            vf.sum()).clamp(min=1.0)

        # every value is >= 0, so amax over zeros is the JAX .at[].max()
        iou_det = iou.detach().clamp(min=0.0) * vf
        tobj = torch.zeros(pi.shape[:4].numel(), device=dev).scatter_reduce_(
            0, flat.reshape(-1), iou_det.reshape(-1), "amax")
        lobj = lobj + bal * batch_mean(bce_with_logits(
            pi[..., 4], tobj.reshape(pi.shape[:4])))

        if num_classes > 1:
            tcls = _one_hot(t["classes"], num_classes) * (cp - cn) + cn
            ce = bce_with_logits(ps[..., 5:], tcls).sum(-1)
            lcls = lcls + (ce * vf).sum() / (
                global_count(vf.sum()) * num_classes).clamp(
                    min=1.0) * num_classes
    return {"loss_box": box_gain * lbox, "loss_obj": obj_gain * lobj,
            "loss_cls": cls_gain * lcls}


def decode_predictions(preds, num_classes, conf_thresh):
    """Raw per-level predictions -> the flat candidate set in canvas
    pixels: (boxes_xyxy [B, N, 4], scores [B, N], classes [B, N],
    valid [B, N]) with N = sum of H_l * W_l * A."""
    all_boxes, all_scores, all_classes, all_valid = [], [], [], []
    for pi, stride, anchors in zip(preds, STRIDES, ANCHORS):
        b, h, w, na, no = pi.shape
        dev = pi.device
        gy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None,
                                                              None]
        gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
        sig = torch.sigmoid(pi)
        px = (sig[..., 0] * 2.0 - 0.5 + gx) * stride
        py = (sig[..., 1] * 2.0 - 0.5 + gy) * stride
        anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
        pw = (sig[..., 2] * 2.0) ** 2 * anc[:, 0]
        ph = (sig[..., 3] * 2.0) ** 2 * anc[:, 1]
        all_boxes.append(torch.stack(
            [px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2],
            -1).reshape(b, -1, 4))
        conf = sig[..., 4:5] * sig[..., 5:]
        score, best = conf.reshape(b, -1, num_classes).max(-1)
        all_scores.append(score)
        all_classes.append(best.to(torch.int32))
        all_valid.append(score > conf_thresh)
    return tuple(torch.cat(x, 1) for x in (all_boxes, all_scores,
                                           all_classes, all_valid))


@contextlib.contextmanager
def _mode(module, train: bool):
    """``module`` in training (or eval) mode for the duration; its mode
    before is restored after."""
    was = module.training
    module.train(train)
    try:
        yield module
    finally:
        module.train(was)


class YoloDetector:
    """Static config + orchestration around the ``YOLOv5`` module, which
    lives on ``device`` (``cuda`` unless the caller asks for another), its
    weights drawn from ``seed`` (``init_variables``). Distillation follows
    the reference's ``YoloDistiller`` (``aldi/yolo/distill.py:85-151``)."""

    def __init__(self, cfg, device=None, seed=0):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.canvas = resolve_canvas(cfg)
        y = cfg.MODEL.YOLO
        self.num_classes = y.NUM_CLASSES
        variant = cfg.MODEL.YAML.split("//")[-1].replace(".yaml", "") \
            or "yolov5m"
        depth_mult, width_mult = MULTIPLES.get(variant, MULTIPLES["yolov5m"])
        a = cfg.DOMAIN_ADAPT.ALIGN
        if a.INS_DA_ENABLED:
            raise ValueError("DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED: YOLO has no "
                             "instance-level alignment (the reference's "
                             "YoloAlignMixin raises too)")
        self.align_level = None
        if a.IMG_DA_ENABLED:
            if a.IMG_DA_LAYER not in ALIGN_LEVELS:
                raise ValueError(
                    f"DOMAIN_ADAPT.ALIGN.IMG_DA_LAYER={a.IMG_DA_LAYER!r}: "
                    f"YOLO aligns one of {sorted(ALIGN_LEVELS)}")
            self.align_level = a.IMG_DA_LAYER
        self.module = YOLOv5(self.num_classes, depth_mult, width_mult,
                             self.dtype, self.align_level).eval()
        self.init_variables(seed)
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN,
                                       dtype=torch.float32, device=self.device)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device)
        self.feat_hws = [(math.ceil(self.canvas[0] / s),
                          math.ceil(self.canvas[1] / s)) for s in STRIDES]
        self.loss_gains = dict(
            box_gain=y.BOX_LOSS_GAIN, obj_gain=y.OBJ_LOSS_GAIN,
            cls_gain=y.CLS_LOSS_GAIN, label_smoothing=y.LABEL_SMOOTHING)
        self.anchor_t = y.ANCHOR_T
        self.conf_thresh = y.CONF_THRESH
        self.iou_thresh = y.IOU_THRES

    # ---------------------------------------------------------------- init
    def init_variables(self, seed: int = 0) -> dict:
        """Re-draw every weight from ``torch.Generator`` ``seed`` on the CPU
        with the JAX package's initializers (BatchNorm at the identity,
        running statistics 0 and 1). Returns the module's state dict."""
        gen = torch.Generator().manual_seed(seed)
        self.module.to("cpu")
        for m in self.module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        self.module.to(self.device)
        return self.module.state_dict()

    def preprocess(self, images):
        """float [B, H, W, 3] in 0..255 -> normalized compute-dtype tensor
        (NHWC); the arithmetic runs in float32."""
        x = (images.to(torch.float32) - self.pixel_mean) / self.pixel_std
        return x.to(self.dtype)

    def _model_fwd(self, module, images, train: bool):
        """(per-level predictions, neck outputs) of ``module`` (the
        detector's own by default) in training or eval mode."""
        module = module or self.module
        with _mode(module, train):  # NHWC -> NCHW in channels_last memory
            return module(self.preprocess(images).permute(0, 3, 1, 2))

    # ------------------------------------------------------------- training
    def forward_train(self, module, images, image_sizes, gt, draws=None,
                      do_align=False, domain_label=1.0):
        """Training forward of ``module`` in training mode (its running
        statistics move) on images [B, H, W, 3] with ground truth ``gt``
        (``Instances`` padded to MAX_GT). YOLO makes no random draw:
        ``draws`` is ignored. Returns (losses, aux); aux carries the
        per-level predictions and the undistilled losses."""
        preds, neck = self._model_fwd(module, images, True)
        targets = build_targets(gt.boxes, gt.classes, gt.valid,
                                self.feat_hws, self.anchor_t)
        losses = yolo_losses(preds, targets, self.num_classes,
                             **self.loss_gains)
        if do_align and self.align_level is not None:
            losses.update(self._align_loss(module, neck, domain_label))
        return losses, {"head_outputs": preds, "std_losses": dict(losses)}

    def _align_loss(self, module, neck, domain_label):
        a = self.cfg.DOMAIN_ADAPT.ALIGN
        f = grad_reverse(neck[ALIGN_LEVELS[self.align_level]])
        preds = (module or self.module).img_align(
            f.permute(0, 2, 3, 1)).to(torch.float32)
        return {"loss_da_img": a.IMG_DA_WEIGHT * batch_mean(bce_with_logits(
            preds, torch.full_like(preds, domain_label)))}

    def forward_domain_align(self, module, images, image_sizes, draws=None,
                             domain_label=0.0):
        """The target_weak stream: the discriminator's loss on ``module``'s
        neck, in training mode, so the running statistics move on this
        stream too (the reference's train-mode target_weak forward,
        ``aldi/trainer.py:108-109``)."""
        _, neck = self._model_fwd(module, images, True)
        if self.align_level is None:
            return {}
        return self._align_loss(module, neck, domain_label)

    # -------------------------------------------------------------- teacher
    @torch.no_grad()
    def forward_teacher_ctx(self, module, images, image_sizes, draws=None,
                            threshold: float = 0.0, max_gt: int = 100):
        """Teacher side of one distill iteration, in eval mode: its
        pseudo-labels and its per-level predictions. Returns (ctx,
        pseudo_gt, metrics)."""
        from ..engine.pseudolabel import detections_to_pseudo_labels

        preds, _ = self._model_fwd(module, images, False)
        dets = self._inference_from_preds(preds, image_sizes)
        pseudo = detections_to_pseudo_labels(*dets, threshold=threshold,
                                             max_gt=max_gt)
        metrics = {"num_pseudo_labels": pseudo.valid.sum().to(torch.float32)
                   / global_batch(max(images.shape[0], 1))}
        return {"head_outputs": preds, "pseudo_gt": pseudo}, pseudo, metrics

    def distill_losses(self, teacher, ctx, s_aux):
        """YoloDistiller's soft losses (``aldi/yolo/distill.py:102-151``):
        objectness BCE against sigmoid(teacher obj / OBJ_TMP) per level
        times ``BALANCE`` and the objectness gain; classification CE against
        softmax(teacher cls / CLS_TMP) at the pseudo-labels' candidate
        cells; regression = the student's box loss on the pseudo-labels.
        The counts are the global batch's (``global_count``, an all-reduce:
        every rank makes the call, in the same order, ``parallel/mesh.py``)."""
        d = self.cfg.DOMAIN_ADAPT.DISTILL
        s_preds = s_aux["head_outputs"]
        t_preds = [p.detach() for p in ctx["head_outputs"]]
        zero = torch.zeros((), device=s_preds[0].device)
        lobj = lcls = zero
        if d.ROIH_CLS_ENABLED:
            pg = ctx["pseudo_gt"]
            targets = build_targets(pg.boxes, pg.classes, pg.valid,
                                    self.feat_hws, self.anchor_t)
        for i, (ps_l, pt_l) in enumerate(zip(s_preds, t_preds)):
            if d.OBJ_ENABLED:
                t_probs = torch.sigmoid(pt_l[..., 4] / d.OBJ_TMP)
                lobj = lobj + batch_mean(bce_with_logits(
                    ps_l[..., 4], t_probs)) * BALANCE[i]
            if d.ROIH_CLS_ENABLED and self.num_classes > 1:
                t = targets[i]
                ps = _gather_cells(ps_l, t)[0][..., 5:].reshape(
                    -1, self.num_classes)
                ts = _gather_cells(pt_l, t)[0][..., 5:].reshape(
                    -1, self.num_classes)
                ce = softmax_cross_entropy(
                    ps, torch.softmax(ts / d.CLS_TMP, dim=-1))
                vf = t["valid"].reshape(-1).float()
                lcls = lcls + (ce * vf).sum() / global_count(
                    vf.sum()).clamp(min=1.0)
        out = {}
        if d.OBJ_ENABLED:
            out["loss_soft_obj"] = lobj * self.loss_gains["obj_gain"]
        if d.ROIH_CLS_ENABLED:
            out["loss_soft_cls"] = lcls * self.loss_gains["cls_gain"]
        if d.ROIH_REG_ENABLED:
            out["loss_soft_reg"] = s_aux["std_losses"]["loss_box"]
        return out

    # ----------------------------------------------------------- inference
    def _inference_from_preds(self, preds, image_sizes):
        """Decode, clip to each image, keep the top ``TOPK_CANDIDATES`` by
        score (ties in index order, as ``jax.lax.top_k``), class-aware NMS,
        then the top TEST.DETECTIONS_PER_IMAGE: (boxes [B, D, 4], scores
        [B, D], classes [B, D] int32, valid [B, D])."""
        boxes, scores, classes, valid = decode_predictions(
            preds, self.num_classes, self.conf_thresh)
        boxes = clip_boxes(boxes, (image_sizes[:, 0, None],
                                   image_sizes[:, 1, None]))
        k = min(TOPK_CANDIDATES, boxes.shape[1])
        vals, idx = top_k(torch.where(valid, scores, -torch.inf), k)
        bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        cl = torch.gather(classes, 1, idx)
        vl = torch.gather(valid, 1, idx) & torch.isfinite(vals)
        keep = batched_nms_keep_mask(bx, vals, cl, vl, self.iou_thresh) & vl
        fs, order = top_k(torch.where(keep, vals, -torch.inf),
                          self.cfg.TEST.DETECTIONS_PER_IMAGE)
        return (torch.gather(bx, 1, order[..., None].expand(-1, -1, 4)), fs,
                torch.gather(cl, 1, order), torch.isfinite(fs))

    @torch.inference_mode()
    def forward_inference(self, images, image_sizes, module=None):
        """Detection inference on the canvas in eval mode. images
        [B, H, W, 3] in 0..255, image_sizes [B, 2] (h, w), both on the
        detector's device; ``module``: the YOLOv5 to run (the EMA teacher,
        say), the detector's own by default. Returns (boxes [B, D, 4],
        scores [B, D], classes [B, D] int32, valid [B, D])."""
        return self.detect(images, image_sizes, module)

    def detect(self, images, image_sizes, module=None):
        """``forward_inference``'s body without its ``inference_mode``, for
        ``torch.export`` (``engine/export.py``): eval mode, so the running
        statistics are constants of the traced graph."""
        preds, _ = self._model_fwd(module, images, False)
        return self._inference_from_preds(preds, image_sizes)
