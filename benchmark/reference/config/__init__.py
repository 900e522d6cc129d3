import torch

from .cfg_node import CfgNode
from .defaults import get_default_cfg


def get_cfg() -> CfgNode:
    """Return a fresh copy of the full default config tree."""
    return get_default_cfg()


def resolve_canvas(cfg) -> tuple:
    """Resolve the static image canvas (H, W).

    If ``TPU.CANVAS`` is (0, 0), derive a canvas big enough for the largest
    train/test resize: shortest edge = max(MIN_SIZE_*), capped at MAX_SIZE_*.
    Both dims rounded up to a multiple of 32 so every FPN level divides evenly.
    """
    h, w = cfg.TPU.CANVAS
    if h and w:
        return (int(h), int(w))
    min_sizes = list(cfg.INPUT.MIN_SIZE_TRAIN) + [cfg.INPUT.MIN_SIZE_TEST]
    short = max(int(s) for s in min_sizes)
    long = max(int(cfg.INPUT.MAX_SIZE_TRAIN), int(cfg.INPUT.MAX_SIZE_TEST))

    def up32(x):
        return ((int(x) + 31) // 32) * 32

    return (up32(short), up32(long))


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def compute_dtype(cfg) -> torch.dtype:
    """The torch dtype the detector computes in: ``TPU.COMPUTE_DTYPE`` when
    set, else bfloat16 under ``SOLVER.AMP.ENABLED`` and float32 otherwise."""
    if cfg.TPU.COMPUTE_DTYPE:
        return _DTYPES[cfg.TPU.COMPUTE_DTYPE]
    return torch.bfloat16 if cfg.SOLVER.AMP.ENABLED else torch.float32


__all__ = ["CfgNode", "get_cfg", "get_default_cfg", "resolve_canvas",
           "compute_dtype"]
