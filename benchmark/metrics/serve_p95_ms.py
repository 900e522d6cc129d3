"""serve_p95_ms: the 95th percentile of every request's latency in the
window, from the call until its outputs are synchronised on the card (the
copy to the card included)."""

from ..harness import quantile


def read(rec):
    lat = rec.get("latencies_ms")
    if not lat or "window_s" not in rec:
        return None
    return quantile(lat, 0.95)
