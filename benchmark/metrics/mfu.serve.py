"""mfu.serve: a request's operations times the traced window's
requests, over its length and the bf16 dense peak."""

from ..readers import mfu


def read(rec):
    return mfu(rec, "requests")
