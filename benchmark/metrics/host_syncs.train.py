"""host_syncs.train: host waits on the device per step, reads and copies
(``aldi/sync/*`` ranges, one a wait)."""

from ..spans import SYNC, count, per


def read(rec):
    return per(rec, "steps",
               lambda t: count(t, lambda n: n.startswith(SYNC)))
