"""host_syncs.serve: host waits on the device per request, reads and copies
(``aldi/sync/*`` ranges, one a wait)."""

from ..spans import SYNC, count, per


def read(rec):
    return per(rec, "requests",
               lambda t: count(t, lambda n: n.startswith(SYNC)))
