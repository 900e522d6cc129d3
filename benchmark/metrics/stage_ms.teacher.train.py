"""stage_ms.teacher.train: device ms per step of the teacher pass
(pseudo-labels and distill targets), between CUDA events at the mark hook."""

from ..readers import stage_ms


def read(rec):
    return stage_ms(rec, lambda name: name.startswith("teacher"))
