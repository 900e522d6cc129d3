"""roofline.k2_bwd.train: K2's backward (ops/roi_align_kernel.py): the
sum of each launch's bound over its two kernels' device time."""

from ..readers import roofline


def read(rec):
    return roofline(rec, ("roi_align_bwd",))
