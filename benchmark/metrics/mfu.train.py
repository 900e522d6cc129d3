"""mfu.train: the DAOD step's operations (flops/<config>.py) times the
traced window's steps, over its length and the bf16 dense peak."""

from ..readers import mfu


def read(rec):
    return mfu(rec, "steps")
