"""Meta-architecture registry and detector builder of the port
(``aldi_tpu/models/__init__.py``). A user registers a detector class, built
as ``cls(cfg, device, seed)``, with ``META_ARCH_REGISTRY.register`` and
names it in MODEL.META_ARCHITECTURE."""

from ..utils.registry import Registry
from .detr import DeformableDETR, DETRDetector  # noqa: F401
from .rcnn import RCNN, RCNNDetector  # noqa: F401
from .yolo import YOLOv5, YoloDetector  # noqa: F401

META_ARCH_REGISTRY = Registry("META_ARCH")
META_ARCH_REGISTRY.register(RCNNDetector, name="GeneralizedRCNN")
META_ARCH_REGISTRY.register(YoloDetector, name="Yolo")
META_ARCH_REGISTRY.register(DETRDetector, name="DeformableDETR")


def build_detector(cfg, device=None, seed=0):
    """cfg -> detector orchestrator on ``device`` (``cuda`` by default;
    raises without a GPU unless ``device="cpu"`` is passed), its weights
    drawn from ``seed``."""
    name = cfg.MODEL.META_ARCHITECTURE
    if cfg.MODEL.LOAD_PROPOSALS and name != "GeneralizedRCNN":
        # precomputed proposals are a two-stage (Fast R-CNN) concept, taken
        # only by the R-CNN's ROI heads, as in detectron2
        raise NotImplementedError(
            f"MODEL.LOAD_PROPOSALS requires GeneralizedRCNN (got {name})")
    return META_ARCH_REGISTRY.get(name)(cfg, device, seed)
