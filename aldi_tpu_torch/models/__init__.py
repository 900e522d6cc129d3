"""Detector builder of the port (``aldi_tpu/models/__init__.py``)."""

from .detr import DeformableDETR, DETRDetector  # noqa: F401
from .rcnn import RCNN, RCNNDetector  # noqa: F401
from .yolo import YOLOv5, YoloDetector  # noqa: F401

DETECTORS = {"GeneralizedRCNN": RCNNDetector, "Yolo": YoloDetector,
             "DeformableDETR": DETRDetector}


def build_detector(cfg, device=None, seed=0):
    """cfg -> detector orchestrator on ``device`` (``cuda`` by default;
    raises without a GPU unless ``device="cpu"`` is passed), its weights
    drawn from ``seed``."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in DETECTORS:
        raise NotImplementedError(
            f"MODEL.META_ARCHITECTURE={name} is not ported yet: ROADMAP.md "
            "lists it under 'Modules still to port'")
    if cfg.MODEL.LOAD_PROPOSALS and name != "GeneralizedRCNN":
        # precomputed proposals are a two-stage (Fast R-CNN) concept, taken
        # only by the R-CNN's ROI heads, as in detectron2
        raise NotImplementedError(
            f"MODEL.LOAD_PROPOSALS requires GeneralizedRCNN (got {name})")
    return DETECTORS[name](cfg, device, seed)
