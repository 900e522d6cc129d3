"""roofline.k2_fwd.serve: K2's forward, ROIAlign (ops/roi_align_kernel.py):
the sum of each launch's bound over its kernel's device time."""

from ..readers import roofline


def read(rec):
    return roofline(rec, ("roi_align_fwd",))
