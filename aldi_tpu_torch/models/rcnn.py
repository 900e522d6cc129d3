"""GeneralizedRCNN: parameter module + inference orchestrator.

Port of ``aldi_tpu/models/rcnn.py`` for the ResNet-FPN backbone and the
serving path (``RCNNDetector.forward_inference``, ``:694-726``). ``RCNN``
holds the weights under detectron2's module names; ``RCNNDetector`` owns the
config state (anchors for the fixed canvas, thresholds, top-k sizes) and
drives the stages. Public stage functions keep the JAX package's layouts:
images [B, H, W, 3] in 0..255, FPN levels NHWC (views of NCHW tensors in
``channels_last`` memory format), pooled features [B, P, 7, 7, C].
"""

import math
from typing import Optional

import torch
from torch import nn

from .. import resolve_device
from ..config import compute_dtype, resolve_canvas
from ..ops.anchors import AnchorGenerator
from .fpn import FPN
from .resnet import ResNet
from .roi_heads import (FastRCNNConvFCHead, FastRCNNOutputLayers, box_pooler,
                        fast_rcnn_inference)
from .rpn import StandardRPNHead, generate_proposals

_NOT_PORTED = ("is not ported yet: ROADMAP.md lists it under 'Modules still "
               "to port'")


class RCNN(nn.Module):
    """Parameter container: ``backbone`` (FPN over ResNet),
    ``proposal_generator.rpn_head``, ``roi_heads.box_head`` and
    ``roi_heads.box_predictor``."""

    def __init__(self, num_classes, num_cell_anchors, depth=50,
                 stride_in_1x1=True, fpn_out_channels=256, rpn_conv_dims=(-1,),
                 num_fc=2, fc_dim=1024, num_conv=0, box_head_norm="",
                 pooler_resolution=7, compute_dtype=torch.float32):
        super().__init__()
        dt = compute_dtype
        self.backbone = FPN(ResNet(depth, stride_in_1x1, dt),
                            out_channels=fpn_out_channels, compute_dtype=dt)
        self.proposal_generator = nn.ModuleDict({"rpn_head": StandardRPNHead(
            fpn_out_channels, num_cell_anchors, rpn_conv_dims, dt)})
        self.roi_heads = nn.ModuleDict({
            "box_head": FastRCNNConvFCHead(
                fpn_out_channels, pooler_resolution, num_fc, fc_dim, num_conv,
                box_head_norm, dt),
            "box_predictor": FastRCNNOutputLayers(
                fc_dim if num_fc else
                fpn_out_channels * pooler_resolution ** 2, num_classes, dt),
        })

    @staticmethod
    def pyramid_strides():
        return [4, 8, 16, 32, 64]


def _check_supported(cfg):
    name = cfg.MODEL.BACKBONE.NAME
    if name != "build_resnet_fpn_backbone":
        raise NotImplementedError(f"MODEL.BACKBONE.NAME={name} {_NOT_PORTED}")
    d = cfg.MODEL.RESNETS.RES5_DILATION
    if d != 1:
        raise NotImplementedError(
            f"MODEL.RESNETS.RES5_DILATION={d}: DC5 is not supported under "
            "the FPN R-CNN family")


class RCNNDetector:
    """Static config + orchestration around the ``RCNN`` module, which
    lives on ``device`` (``cuda`` unless the caller asks for another)."""

    def __init__(self, cfg, device=None):
        _check_supported(cfg)
        self.device = resolve_device(device)
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
        self.pixel_mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device)
        self.pixel_std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32,
                                      device=self.device)

        box = cfg.MODEL.ROI_BOX_HEAD
        self.module = RCNN(
            num_classes=self.num_classes,
            num_cell_anchors=anchor_gen.num_cell_anchors,
            depth=cfg.MODEL.RESNETS.DEPTH,
            stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
            fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
            rpn_conv_dims=tuple(cfg.MODEL.RPN.CONV_DIMS),
            num_fc=box.NUM_FC, fc_dim=box.FC_DIM, num_conv=box.NUM_CONV,
            box_head_norm=box.NORM,
            pooler_resolution=box.POOLER_RESOLUTION,
            compute_dtype=self.dtype,
        ).eval()
        self.init_variables(seed=0)

        self.rpn_box_reg_weights = tuple(cfg.MODEL.RPN.BBOX_REG_WEIGHTS)
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
    def backbone(self, images):
        """Normalized NHWC images -> [p2, ..., p6], each NHWC."""
        feats = self.module.backbone(images.permute(0, 3, 1, 2))
        return [f.permute(0, 2, 3, 1) for f in feats]

    def rpn_head(self, features):
        return self.module.proposal_generator["rpn_head"](
            [f.permute(0, 3, 1, 2) for f in features])

    def proposals(self, logits, deltas, image_sizes):
        c = self.cfg.MODEL.RPN
        return generate_proposals(
            logits, deltas, self.anchors, image_sizes,
            pre_nms_topk=c.PRE_NMS_TOPK_TEST,
            post_nms_topk=c.POST_NMS_TOPK_TEST,
            nms_thresh=c.NMS_THRESH,
            min_size=self.cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
            box_reg_weights=self.rpn_box_reg_weights,
        )

    def box_head(self, features, boxes, valid):
        """NHWC levels + boxes [B, S, 4] -> (cls_logits [B, S, K+1],
        deltas [B, S, K*4], box_features [B, S, fc_dim])."""
        pooled = box_pooler([f.contiguous() for f in features[:-1]], boxes,
                            valid, self.roi_strides, self.pooler_resolution)
        b, s = pooled.shape[:2]
        heads = self.module.roi_heads
        x = heads["box_head"](pooled.reshape((b * s,) + pooled.shape[2:]))
        cls, reg = heads["box_predictor"](x)
        return cls.reshape(b, s, -1), reg.reshape(b, s, -1), x.reshape(b, s, -1)

    # ----------------------------------------------------------- inference
    @torch.inference_mode()
    def forward_inference(self, images, image_sizes,
                          precomputed: Optional[dict] = None):
        """Detection inference on the canvas (no rescaling to original image
        space). images [B, H, W, 3] float in 0..255, image_sizes [B, 2]
        (h, w), both on the detector's device. Returns (boxes [B, D, 4],
        scores [B, D], classes [B, D] int32, valid [B, D])."""
        if precomputed is not None:
            raise NotImplementedError(f"MODEL.LOAD_PROPOSALS {_NOT_PORTED}")
        feats = self.backbone(self.preprocess(images))
        logits, deltas = self.rpn_head(feats)
        pboxes, _, pvalid = self.proposals(logits, deltas, image_sizes)
        cls_logits, box_deltas, _ = self.box_head(feats, pboxes, pvalid)
        r = self.cfg.MODEL.ROI_HEADS
        return fast_rcnn_inference(
            pboxes, pvalid, cls_logits, box_deltas, image_sizes,
            self.num_classes,
            score_thresh=r.SCORE_THRESH_TEST,
            nms_thresh=r.NMS_THRESH_TEST,
            topk_per_image=self.cfg.TEST.DETECTIONS_PER_IMAGE,
            box_reg_weights=self.box_reg_weights,
        )
