"""roofline.k1.train: K1a + K1b, the anchor matcher (ops/match_kernel.py):
the sum of each launch's bound over its kernels' device time."""

from ..readers import roofline


def read(rec):
    return roofline(rec, ("match_iou", "low_quality_mask"))
