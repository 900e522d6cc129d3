"""stage_ms.streams.train: device ms per step of the student streams'
forward and backward, summed over the streams and chunks."""

from ..readers import stage_ms


def read(rec):
    return stage_ms(rec, lambda name: "stream" in name)
