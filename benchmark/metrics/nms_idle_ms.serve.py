"""nms_idle_ms.serve: device idle ms per request in the gaps that open
while NMS's fixed-point loop runs (``aldi/nms``: the RPN's and the
class-aware NMS; the queue runs dry at its exit tests)."""

from ..spans import NMS, idle_opening_in, per


def read(rec):
    return per(rec, "requests",
               lambda t: 1e3 * idle_opening_in(t, lambda n: n == NMS))
