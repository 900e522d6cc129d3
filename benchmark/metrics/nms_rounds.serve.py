"""nms_rounds.serve: NMS exit tests per request (``aldi/sync/nms_exit``
ranges, one after each round of 8 fixed-point steps), over both NMS
calls of a request."""

from ..spans import SYNC, count, per


def read(rec):
    return per(rec, "requests",
               lambda t: count(t, lambda n: n == SYNC + "nms_exit"))
