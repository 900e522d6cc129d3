"""sync_idle_ms.serve: device idle ms per request in the gaps that open
inside an ``aldi/sync/*`` range (the queue ran dry while the host
waited)."""

from ..spans import SYNC, idle_opening_in, per


def read(rec):
    return per(rec, "requests", lambda t: 1e3 * idle_opening_in(
        t, lambda n: n.startswith(SYNC)))
