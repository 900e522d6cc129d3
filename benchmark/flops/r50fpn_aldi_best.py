"""Operations of R50-FPN's ALDI++ step and serving request."""

from ..reference.config import resolve_canvas
from . import parts


def _parts(cfg):
    canvas = resolve_canvas(cfg)
    r = cfg.MODEL.RESNETS
    b = cfg.MODEL.ROI_BOX_HEAD
    n_cls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    channels = cfg.MODEL.FPN.OUT_CHANNELS

    def box_head(rois):
        return parts.box_head(rois, n_cls, b.NUM_CONV, b.NUM_FC, b.FC_DIM,
                              channels, b.CONV_DIM, b.POOLER_RESOLUTION)

    def forward(n, rois):
        """(frozen, trained) of a forward of n images with rois boxes each."""
        frozen, trained, shapes = parts.resnet(
            r.DEPTH, r.STRIDE_IN_1X1, cfg.MODEL.BACKBONE.FREEZE_AT, *canvas)
        for f, t in (parts.fpn(shapes, channels),
                     parts.rpn_head(canvas, len(cfg.MODEL.RPN.CONV_DIMS),
                                    channels=channels),
                     box_head(rois)):
            frozen, trained = frozen + f, trained + t
        return n * frozen, n * trained

    return forward, box_head


def step(cfg, n_labeled, n_unlabeled) -> float:
    forward, box_head = _parts(cfg)
    return parts.daod_step(forward, n_labeled, n_unlabeled,
                           cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
                           cfg.MODEL.RPN.POST_NMS_TOPK_TEST, box_head)


def request(cfg, n) -> float:
    forward, _ = _parts(cfg)
    return sum(forward(n, cfg.MODEL.RPN.POST_NMS_TOPK_TEST))
