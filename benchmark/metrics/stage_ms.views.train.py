"""stage_ms.views.train: device ms per step of the strong views."""

from ..readers import stage_ms


def read(rec):
    return stage_ms(rec, lambda name: name == "strong views")
