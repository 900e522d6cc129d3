"""GeneralizedRCNN: parameter module + train/inference orchestrator.

Port of ``aldi_tpu/models/rcnn.py`` for the ResNet-FPN, ConvNeXt-FPN and
ViTDet-B/L backbones (``MODEL.BACKBONE.NAME``, ``:130-193``): the serving
path (``RCNNDetector.forward_inference``, ``:694-726``) and the DAOD
training interface (``forward_train``, ``forward_teacher``,
``forward_teacher_ctx``, ``distill_losses``, ``:379-659``; Fast R-CNN on
precomputed proposals, MODEL.LOAD_PROPOSALS, ``:415-446,706-708``) with
adversarial domain alignment (``grad_reverse``, the image- and
instance-level discriminators, ``_align_losses`` and the target_weak
stream's ``forward_domain_align``, ``:45-94,504-528,662-691``). ``RCNN`` holds
the weights under detectron2's module names; ``RCNNDetector`` owns the
config state (anchors for the fixed canvas, thresholds, top-k sizes) and
drives the stages. The JAX methods take a variables tree first; the
training methods here take the ``RCNN`` module to run (the student or the
EMA teacher). Public stage functions keep the JAX package's layouts:
images [B, H, W, 3] in 0..255, FPN levels NHWC (views of NCHW tensors in
``channels_last`` memory format), pooled features [B, P, 7, 7, C]. The
ViTDet and ConvNeXt backbones take drop-path keep masks in training
(``draws["drop"]``, of the shape their ``keep_rates()`` gives); the teacher
and serving run without drop path.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import compute_dtype, resolve_canvas
from ..ops.anchors import AnchorGenerator
from ..ops.losses import bce_with_logits
from ..mesh import batch_mean, global_batch
from .fpn import FPN
from .layers import DenseConv2d, DenseLinear
from .resnet import ResNet
from .roi_heads import (FastRCNNConvFCHead, FastRCNNOutputLayers, box_pooler,
                        fast_rcnn_inference, fast_rcnn_losses,
                        sample_proposals)
from .rpn import (StandardRPNHead, generate_proposals, label_anchors_sampled,
                  rpn_losses, rpn_losses_dense)
from .vit import ViTDetBackbone

VIT_BACKBONES = ("build_vitdet_b_backbone", "build_vitdet_l_backbone")
CONVNEXT_BACKBONE = "build_convnext_fpn_backbone"
ALIGN_LEVELS = {"p2": 0, "p3": 1, "p4": 2, "p5": 3, "p6": 4}


class GradReverse(torch.autograd.Function):
    """The identity forward, the negated gradient backward (the gradient
    reversal layer of weight -1, reference ``aldi/helpers.py:51-63``)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -grad


def grad_reverse(x):
    return GradReverse.apply(x)


class ConvDiscriminator(nn.Module):
    """NHWC features -> (conv 3x3 VALID -> ReLU) per hidden width -> mean
    over the pixels -> Linear(1): logits [B, 1] (reference
    ``aldi/align.py:103-119``)."""

    def __init__(self, in_channels, hidden_dims, compute_dtype):
        super().__init__()
        self.depth = len(hidden_dims)
        for i, d in enumerate(hidden_dims):
            self.add_module(f"conv{i}", DenseConv2d(
                in_channels, d, 3, compute_dtype=compute_dtype))
            in_channels = d
        self.linear = DenseLinear(in_channels, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.linear(x.mean(dim=(2, 3)))


class FCDiscriminator(nn.Module):
    """[N, D] features -> (Linear -> ReLU) per hidden width -> Linear(1):
    logits [N, 1] (reference ``aldi/align.py:121-136``)."""

    def __init__(self, in_features, hidden_dims, compute_dtype):
        super().__init__()
        self.depth = len(hidden_dims)
        for i, d in enumerate(hidden_dims):
            self.add_module(f"linear{i}", DenseLinear(
                in_features, d, compute_dtype=compute_dtype))
            in_features = d
        self.linear_out = DenseLinear(in_features, 1,
                                      compute_dtype=compute_dtype)

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"linear{i}")(x))
        return self.linear_out(x)


class RCNN(nn.Module):
    """Parameter container: ``backbone`` (FPN over ResNet or ConvNeXt, or
    ViTDet's ``net`` + ``simfp_*``), ``proposal_generator.rpn_head``,
    ``roi_heads.box_head``, ``roi_heads.box_predictor`` and, with domain
    alignment, the discriminators ``img_align`` and ``ins_align``.

    ``backbone_name`` is MODEL.BACKBONE.NAME; a ViTDet backbone is built
    for the canvas's stride-16 ``grid`` (its global blocks' rel-pos tables
    have the grid's size); ``convnext`` holds the ConvNeXt's ``depths``,
    ``dims``, ``drop_path_rate`` and ``layer_scale_init``.
    ``img_da_hidden_dims`` / ``ins_da_hidden_dims`` (None: that
    discriminator is off) are the discriminators' hidden widths; their
    inputs are the pyramid's channels and the box head's features."""

    def __init__(self, num_classes, num_cell_anchors,
                 backbone_name="build_resnet_fpn_backbone", depth=50,
                 stride_in_1x1=True, fpn_out_channels=256, rpn_conv_dims=(-1,),
                 num_fc=2, fc_dim=1024, num_conv=0, conv_dim=256,
                 box_head_norm="", pooler_resolution=7,
                 compute_dtype=torch.float32, freeze_at=0, grid=None,
                 use_act_checkpoint=True, convnext=None,
                 img_da_hidden_dims=None, ins_da_hidden_dims=None):
        super().__init__()
        dt = compute_dtype
        if backbone_name in VIT_BACKBONES:
            self.backbone = ViTDetBackbone(
                backbone_name.split("_")[2], grid, fpn_out_channels,
                use_act_checkpoint, dt)
        else:
            self.backbone = FPN(ResNet(depth, stride_in_1x1, dt, freeze_at),
                                out_channels=fpn_out_channels,
                                compute_dtype=dt)
        self.proposal_generator = nn.ModuleDict({"rpn_head": StandardRPNHead(
            fpn_out_channels, num_cell_anchors, rpn_conv_dims, dt)})
        self.roi_heads = nn.ModuleDict({
            "box_head": FastRCNNConvFCHead(
                fpn_out_channels, pooler_resolution, num_fc, fc_dim, num_conv,
                box_head_norm, dt, conv_dim),
            "box_predictor": FastRCNNOutputLayers(
                fc_dim if num_fc else
                fpn_out_channels * pooler_resolution ** 2, num_classes, dt),
        })
        if img_da_hidden_dims is not None:
            self.img_align = ConvDiscriminator(fpn_out_channels,
                                               img_da_hidden_dims, dt)
        if ins_da_hidden_dims is not None:
            box_dim = fc_dim if num_fc else (
                (conv_dim if num_conv else fpn_out_channels)
                * pooler_resolution ** 2)
            self.ins_align = FCDiscriminator(box_dim, ins_da_hidden_dims, dt)

    @staticmethod
    def pyramid_strides():
        return [4, 8, 16, 32, 64]


def _check_supported(cfg):
    """The JAX package's errors, with its texts: an unknown backbone
    (``aldi_tpu/models/rcnn.py:164``) and RES5_DILATION other than 1
    (``:248-254``)."""
    name = cfg.MODEL.BACKBONE.NAME
    if name not in ("build_resnet_fpn_backbone", CONVNEXT_BACKBONE) \
            + VIT_BACKBONES:
        raise ValueError(f"Unknown backbone {name}")
    d = cfg.MODEL.RESNETS.RES5_DILATION
    if d != 1:
        raise NotImplementedError(
            f"MODEL.RESNETS.RES5_DILATION={d}: DC5 is not supported under "
            "the FPN R-CNN family (the DETR family supports DC5 via "
            "MODEL.DEFORMABLE_DETR.DILATION)")


class RCNNDetector:
    """Static config + orchestration around the ``RCNN`` module, which
    lives on ``device`` (``cuda`` unless the caller asks for another), its
    weights drawn from ``seed`` (``init_variables``)."""

    def __init__(self, cfg, device=None, seed=0):
        _check_supported(cfg)
        self.device = torch.device(device)
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.canvas = resolve_canvas(cfg)
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        self.strides = RCNN.pyramid_strides()
        self.rpn_strides = self.strides  # RPN runs on p2..p6
        self.roi_strides = self.strides[:-1]  # ROI pooling on p2..p5

        anchor_gen = AnchorGenerator.from_config(cfg, self.rpn_strides)
        feat_hws = [(math.ceil(self.canvas[0] / s), math.ceil(self.canvas[1] / s))
                    for s in self.rpn_strides]
        self.anchors = [torch.as_tensor(a, device=self.device)
                        for a in anchor_gen(feat_hws)]
        self.anchors_cat = torch.cat(self.anchors, 0)
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device)

        box = cfg.MODEL.ROI_BOX_HEAD
        cn, align = cfg.MODEL.CONVNEXT, cfg.DOMAIN_ADAPT.ALIGN
        self.module = RCNN(
            num_classes=self.num_classes,
            num_cell_anchors=anchor_gen.num_cell_anchors,
            backbone_name=cfg.MODEL.BACKBONE.NAME,
            depth=cfg.MODEL.RESNETS.DEPTH,
            stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
            fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            rpn_conv_dims=tuple(cfg.MODEL.RPN.CONV_DIMS),
            num_fc=box.NUM_FC, fc_dim=box.FC_DIM, num_conv=box.NUM_CONV,
            conv_dim=box.CONV_DIM, box_head_norm=box.NORM,
            pooler_resolution=box.POOLER_RESOLUTION,
            compute_dtype=self.dtype,
            freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
            grid=(self.canvas[0] // 16, self.canvas[1] // 16),
            use_act_checkpoint=cfg.VIT.USE_ACT_CHECKPOINT,
            convnext=dict(depths=tuple(cn.DEPTHS), dims=tuple(cn.DIMS),
                          drop_path_rate=cn.DROP_PATH_RATE,
                          layer_scale_init=cn.LAYER_SCALE_INIT_VALUE),
            img_da_hidden_dims=(tuple(align.IMG_DA_HIDDEN_DIMS)
                                if align.IMG_DA_ENABLED else None),
            ins_da_hidden_dims=(tuple(align.INS_DA_HIDDEN_DIMS)
                                if align.INS_DA_ENABLED else None),
        ).eval()
        self.init_variables(seed)

        rpn = cfg.MODEL.RPN
        self.rpn_box_reg_weights = tuple(rpn.BBOX_REG_WEIGHTS)
        self.rpn_params = dict(
            batch_size_per_image=rpn.BATCH_SIZE_PER_IMAGE,
            positive_fraction=rpn.POSITIVE_FRACTION,
            box_reg_weights=self.rpn_box_reg_weights,
            smooth_l1_beta=rpn.SMOOTH_L1_BETA,
        )
        roi = cfg.MODEL.ROI_HEADS
        self.roi_sample_params = dict(
            num_classes=self.num_classes,
            batch_size_per_image=roi.BATCH_SIZE_PER_IMAGE,
            positive_fraction=roi.POSITIVE_FRACTION,
            iou_threshold=roi.IOU_THRESHOLDS[0],
            append_gt=roi.PROPOSAL_APPEND_GT,
        )
        self.box_reg_weights = tuple(box.BBOX_REG_WEIGHTS)
        self.pooler_resolution = box.POOLER_RESOLUTION

    # ---------------------------------------------------------------- init
    def init_variables(self, seed: int = 0) -> dict:
        """Re-draw every weight from ``torch.Generator`` ``seed`` with the
        JAX package's initializers (FrozenBN stays the identity). The draws
        are made on the CPU, so a seed gives the same weights on any device.
        Returns the module's state dict."""
        gen = torch.Generator().manual_seed(seed)
        self.module.to("cpu")
        for m in self.module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        self.module.to(self.device)
        return self.module.state_dict()

    # ---------------------------------------------------------- preprocess
    def preprocess(self, images):
        """float [B, H, W, 3] in 0..255 (cfg INPUT.FORMAT channel order) ->
        normalized compute-dtype tensor; the arithmetic runs in float32."""
        x = (images.to(torch.float32) - self.pixel_mean) / self.pixel_std
        return x.to(self.dtype)

    # -------------------------------------------------------------- stages
    # ``module``: the RCNN to run, the detector's own by default
    def backbone(self, images, module=None, drop=None):
        """Normalized NHWC images -> [p2, ..., p6], each NHWC. ``drop``: the
        trunk's drop-path keep masks (training only): [2, depth, B] for a
        ViT, [sum(depths), B] for a ConvNeXt."""
        net = (module or self.module).backbone
        x = images.permute(0, 3, 1, 2)
        if torch.is_grad_enabled():
            # the reference's memory at the timed batch: one image at a
            # time, its trunk's activations made again in the backward
            # (``runner.detector`` turns a ViT's own block checkpoints off)
            per_image = [checkpoint(
                net, x[i:i + 1], None if drop is None
                else drop[..., i:i + 1], use_reentrant=False)
                for i in range(x.shape[0])]
            feats = [torch.cat(level) for level in zip(*per_image)]
        else:
            feats = net(x, drop)
        return [f.permute(0, 2, 3, 1) for f in feats]

    def rpn_head(self, features, module=None):
        head = (module or self.module).proposal_generator["rpn_head"]
        levels = [f.permute(0, 3, 1, 2) for f in features]
        if not torch.is_grad_enabled():
            return head(levels)
        # one image at a time under a checkpoint, as the trunk
        per_image = [checkpoint(head, [f[i:i + 1] for f in levels],
                                use_reentrant=False)
                     for i in range(levels[0].shape[0])]
        return ([torch.cat(lv) for lv in zip(*(o[0] for o in per_image))],
                [torch.cat(lv) for lv in zip(*(o[1] for o in per_image))])

    def proposals(self, logits, deltas, image_sizes, train=False):
        """RPN proposals at the train or the test top-k sizes."""
        c = self.cfg.MODEL.RPN
        return generate_proposals(
            logits, deltas, self.anchors, image_sizes,
            pre_nms_topk=c.PRE_NMS_TOPK_TRAIN if train else c.PRE_NMS_TOPK_TEST,
            post_nms_topk=(c.POST_NMS_TOPK_TRAIN if train
                           else c.POST_NMS_TOPK_TEST),
            nms_thresh=c.NMS_THRESH,
            min_size=self.cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
            box_reg_weights=self.rpn_box_reg_weights,
        )

    def box_head(self, features, boxes, valid, module=None):
        """NHWC levels + boxes [B, S, 4] -> (cls_logits [B, S, K+1],
        deltas [B, S, K*4], box_features [B, S, fc_dim])."""
        pooled = box_pooler([f.contiguous() for f in features[:-1]], boxes,
                            valid, self.roi_strides, self.pooler_resolution)
        b, s = pooled.shape[:2]
        heads = (module or self.module).roi_heads
        x = heads["box_head"](pooled.reshape((b * s,) + pooled.shape[2:]))
        cls, reg = heads["box_predictor"](x)
        return cls.reshape(b, s, -1), reg.reshape(b, s, -1), x.reshape(b, s, -1)

    def _rpn_outputs(self, feats, module):
        """RPN head outputs per level and concatenated over levels in
        anchor order, float32: (logits, deltas, logits_cat, deltas_cat)."""
        logits, deltas = self.rpn_head(feats, module)
        return (logits, deltas,
                torch.cat([lg.to(torch.float32) for lg in logits], 1),
                torch.cat([d.to(torch.float32) for d in deltas], 1))

    # ---------------------------------------------------------- train pass
    def forward_train(self, module, images, image_sizes, gt, draws,
                      do_align=False, domain_label=1.0, precomputed=None):
        """Full training forward of ``module`` on images [B, H, W, 3] with
        ground truth ``gt`` (``Instances`` padded to MAX_GT). ``draws``:
        ``{"rpn": ..., "roi": ...}`` (and ``"drop"`` for a ViT or ConvNeXt
        backbone) from ``engine.train_step.draw_step``; the RPN's are those
        of TPU.RPN_LOSS_IMPL's loss. ``do_align`` adds the discriminators'
        losses against ``domain_label`` (1 for the source domain).
        ``precomputed``: ``{"boxes" [B, K, 4], "valid" [B, K]}``, region
        proposals from a file (MODEL.LOAD_PROPOSALS, Fast R-CNN): the RPN
        head does not run and adds no loss, and the ROI sampler takes these
        proposals (with the gt appended).
        Returns (losses, aux); aux carries the RPN head outputs
        (concatenated over levels, float32; not with ``precomputed``), the
        sampled ROI set and the box predictor's outputs on it, for the
        distill losses."""
        feats = self.backbone(self.preprocess(images), module,
                              draws.get("drop"))
        aux = {}
        if precomputed is not None:
            losses = {}
            pboxes, pvalid = precomputed["boxes"], precomputed["valid"]
        else:
            logits, deltas, logits_cat, deltas_cat = self._rpn_outputs(
                feats, module)
            loss_fn = (rpn_losses if self.cfg.TPU.RPN_LOSS_IMPL == "sampled"
                       else rpn_losses_dense)
            losses = loss_fn(self.anchors_cat, logits_cat, deltas_cat,
                             gt.boxes, gt.valid, draws["rpn"],
                             **self.rpn_params)
            aux.update(rpn_logits=logits_cat, rpn_deltas=deltas_cat)
            # proposals are constants of the ROI stage (the JAX package's
            # stop_gradient): no gradient through decode, NMS and top-k
            with torch.no_grad():
                pboxes, _, pvalid = self.proposals(logits, deltas,
                                                   image_sizes, train=True)
        sampled = sample_proposals(pboxes, pvalid, gt.boxes, gt.classes,
                                   gt.valid, draws["roi"],
                                   **self.roi_sample_params)
        cls_logits, box_deltas, box_feats = self.box_head(
            feats, sampled["boxes"], sampled["valid"], module)
        losses.update(fast_rcnn_losses(
            cls_logits, box_deltas, sampled, self.num_classes,
            self.box_reg_weights, self.cfg.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA))
        if do_align:
            losses.update(self._align_losses(module, feats, box_feats,
                                             domain_label))
        aux.update(sampled=sampled,
                   roih_cls_logits=cls_logits.to(torch.float32),
                   roih_deltas=box_deltas.to(torch.float32))
        return losses, aux

    def _align_losses(self, module, feats, box_feats, domain_label):
        """The discriminators' float32 BCE against ``domain_label`` behind
        the gradient reversal, times their weights: the image level on the
        pyramid level IMG_DA_LAYER, the instance level on the box head's
        features [B, S, D], its mean over all B x S sampled slots (the
        invalid ones included, as the JAX package takes it). Each mean is
        the global batch's (``batch_mean``)."""
        a = self.cfg.DOMAIN_ADAPT.ALIGN
        module = module or self.module
        out = {}
        if a.IMG_DA_ENABLED:
            f = grad_reverse(feats[ALIGN_LEVELS[a.IMG_DA_LAYER]])
            preds = module.img_align(f).to(torch.float32)
            out["loss_da_img"] = a.IMG_DA_WEIGHT * batch_mean(
                bce_with_logits(preds, torch.full_like(preds, domain_label)))
        if a.INS_DA_ENABLED:
            b, s = box_feats.shape[:2]
            preds = module.ins_align(grad_reverse(box_feats).reshape(
                b * s, -1)).reshape(b, s).to(torch.float32)
            out["loss_da_ins"] = a.INS_DA_WEIGHT * batch_mean(
                bce_with_logits(preds, torch.full_like(preds, domain_label)))
        return out

    def forward_domain_align(self, module, images, image_sizes, draws,
                             domain_label=0.0):
        """The target_weak stream (reference ``aldi/trainer.py:108-109``):
        only the alignment losses of ``module`` on images [B, H, W, 3]. The
        backbone runs in training mode (``draws["drop"]`` for a ViT or
        ConvNeXt trunk); with instance alignment, the RPN's proposals at
        the train top-k, without gradient, are sampled (``draws["roi"]``)
        against an empty gt set (one invalid slot, as the reference's
        unlabeled mapper strips the annotations) and go through the box
        head."""
        feats = self.backbone(self.preprocess(images), module,
                              draws.get("drop"))
        box_feats = None
        if self.cfg.DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED:
            with torch.no_grad():
                logits, deltas = self.rpn_head(feats, module)
                pboxes, _, pvalid = self.proposals(logits, deltas,
                                                   image_sizes, train=True)
            b, dev = images.shape[0], images.device
            sampled = sample_proposals(
                pboxes, pvalid, torch.zeros((b, 1, 4), device=dev),
                torch.zeros((b, 1), dtype=torch.int32, device=dev),
                torch.zeros((b, 1), dtype=torch.bool, device=dev),
                draws["roi"], **self.roi_sample_params)
            _, _, box_feats = self.box_head(feats, sampled["boxes"],
                                            sampled["valid"], module)
        return self._align_losses(module, feats, box_feats, domain_label)

    # -------------------------------------------------------- teacher pass
    @torch.no_grad()
    def forward_teacher(self, module, images, image_sizes):
        """One teacher pass (no gradient, but tensors an autograd graph may
        later save, unlike ``inference_mode``): backbone + RPN head once,
        detections on the test top-k path. Returns (features, rpn_logits_cat,
        rpn_deltas_cat, detections)."""
        feats = self.backbone(self.preprocess(images), module)
        logits, deltas, logits_cat, deltas_cat = self._rpn_outputs(
            feats, module)
        pboxes, _, pvalid = self.proposals(logits, deltas, image_sizes)
        cls_logits, box_deltas, _ = self.box_head(feats, pboxes, pvalid,
                                                  module)
        r = self.cfg.MODEL.ROI_HEADS
        dets = fast_rcnn_inference(
            pboxes, pvalid, cls_logits, box_deltas, image_sizes,
            self.num_classes, score_thresh=r.SCORE_THRESH_TEST,
            nms_thresh=r.NMS_THRESH_TEST,
            topk_per_image=self.cfg.TEST.DETECTIONS_PER_IMAGE,
            box_reg_weights=self.box_reg_weights)
        return feats, logits_cat, deltas_cat, dets

    @torch.no_grad()
    def forward_teacher_ctx(self, module, images, image_sizes, draws,
                            threshold: float, max_gt: int):
        """Teacher side of one distill iteration: pseudo-labels and what
        ``distill_losses`` needs. ``draws`` are those of the anchor sampler
        against the pseudo-labels. Returns (ctx, pseudo_gt, metrics)."""
        from ..engine.pseudolabel import detections_to_pseudo_labels

        feats, rpn_logits, rpn_deltas, dets = self.forward_teacher(
            module, images, image_sizes)
        pseudo = detections_to_pseudo_labels(*dets, threshold=threshold,
                                             max_gt=max_gt)
        d = self.cfg.DOMAIN_ADAPT.DISTILL
        ctx = {"feats": feats}
        if d.OBJ_ENABLED or d.RPN_REG_ENABLED:
            # the distill anchor set, sampled against the pseudo-labels, and
            # the teacher's head outputs gathered at it
            idx, valid, fg, _ = label_anchors_sampled(
                self.anchors_cat, pseudo.boxes, pseudo.valid, draws,
                batch_size_per_image=self.rpn_params["batch_size_per_image"],
                positive_fraction=self.rpn_params["positive_fraction"])
            ctx.update(
                anchor_idx=idx, anchor_valid=valid, anchor_fg=fg,
                t_obj=torch.gather(rpn_logits, 1, idx),
                t_delta=torch.gather(rpn_deltas, 1,
                                     idx[..., None].expand(-1, -1, 4)))
        metrics = {"num_pseudo_labels": pseudo.valid.sum().to(torch.float32)
                   / global_batch(max(images.shape[0], 1))}
        return ctx, pseudo, metrics

    def distill_losses(self, teacher, ctx, s_aux):
        """Soft distillation losses between the teacher context and the
        student's aux from its pass on the pseudo-labels; the teacher's box
        head runs (without gradient) on the student's sampled ROI set."""
        from ..engine.distill import roih_distill_losses, rpn_distill_losses

        d = self.cfg.DOMAIN_ADAPT.DISTILL
        out = {}
        sampled = {k: v.detach() for k, v in s_aux["sampled"].items()}
        with torch.no_grad():
            t_cls, t_deltas, _ = self.box_head(
                ctx["feats"], sampled["boxes"], sampled["valid"], teacher)
        t_cls, t_deltas = t_cls.to(torch.float32), t_deltas.to(torch.float32)
        if d.OBJ_ENABLED or d.RPN_REG_ENABLED:
            idx = ctx["anchor_idx"]
            out.update(rpn_distill_losses(
                torch.gather(s_aux["rpn_logits"], 1, idx),
                torch.gather(s_aux["rpn_deltas"], 1,
                             idx[..., None].expand(-1, -1, 4)),
                ctx["t_obj"], ctx["t_delta"], ctx["anchor_valid"],
                ctx["anchor_fg"], obj_temperature=d.OBJ_TMP,
                do_obj=d.OBJ_ENABLED, do_reg=d.RPN_REG_ENABLED))
        if d.ROIH_CLS_ENABLED or d.ROIH_REG_ENABLED:
            out.update(roih_distill_losses(
                s_aux["roih_cls_logits"], s_aux["roih_deltas"], t_cls,
                t_deltas, sampled["valid"], self.num_classes,
                cls_temperature=d.CLS_TMP,
                cls_loss_type=self.cfg.DOMAIN_ADAPT.CLS_LOSS_TYPE,
                do_cls=d.ROIH_CLS_ENABLED, do_reg=d.ROIH_REG_ENABLED))
        return out

    # ----------------------------------------------------------- inference
    @torch.inference_mode()
    def forward_inference(self, images, image_sizes,
                          precomputed: Optional[dict] = None, module=None):
        """Detection inference on the canvas (no rescaling to original image
        space). images [B, H, W, 3] in 0..255 (float or uint8),
        image_sizes [B, 2] (h, w), both on the detector's device;
        ``module``: the RCNN to run (the EMA teacher, say), the detector's
        own by default. ``precomputed``: ``{"boxes" [B, K, 4], "valid"
        [B, K]}``, MODEL.LOAD_PROPOSALS's proposals, which the box head
        scores instead of the RPN's (Fast R-CNN inference). Returns (boxes
        [B, D, 4], scores [B, D], classes [B, D] int32, valid [B, D])."""
        return self.detect(images, image_sizes, module, precomputed)

    def detect(self, images, image_sizes, module=None, precomputed=None,
               candidates=None):
        """``forward_inference``'s body without its ``inference_mode``, which
        ``torch.export`` cannot trace: the exported serving module
        (``engine/export.py``) runs it under ``no_grad``, without
        ``precomputed``."""
        feats = self.backbone(self.preprocess(images), module)
        if precomputed is not None:
            pboxes, pvalid = precomputed["boxes"], precomputed["valid"]
        else:
            logits, deltas = self.rpn_head(feats, module)
            pboxes, _, pvalid = self.proposals(logits, deltas, image_sizes)
        cls_logits, box_deltas, _ = self.box_head(feats, pboxes, pvalid,
                                                  module)
        r = self.cfg.MODEL.ROI_HEADS
        return fast_rcnn_inference(
            pboxes, pvalid, cls_logits, box_deltas, image_sizes,
            self.num_classes,
            score_thresh=r.SCORE_THRESH_TEST,
            nms_thresh=r.NMS_THRESH_TEST,
            topk_per_image=self.cfg.TEST.DETECTIONS_PER_IMAGE,
            box_reg_weights=self.box_reg_weights,
            candidates=candidates,
        )
