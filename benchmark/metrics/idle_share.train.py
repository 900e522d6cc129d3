"""idle_share.train: the traced window's share without a kernel, copy
or memset on the device."""

from ..readers import idle_share


def read(rec):
    return idle_share(rec)
