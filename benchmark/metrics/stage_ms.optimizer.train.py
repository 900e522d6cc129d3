"""stage_ms.optimizer.train: device ms per step of the EMA update and the
optimizer (with the gradients' clip and the learning rate)."""

from ..readers import stage_ms


def read(rec):
    return stage_ms(rec, lambda name: name in ("ema update", "optimizer"))
