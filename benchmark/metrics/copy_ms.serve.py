"""copy_ms.serve: device ms per request of the copies from the host to
the card (the request's images) in the traced window."""


def read(rec):
    t = rec.get("trace")
    if not t or not rec.get("requests"):
        return None
    s = sum(end - start for start, end, name, cat in t["device"]
            if cat == "gpu_memcpy" and "HtoD" in name) * 1e-6
    return 1e3 * s / rec["requests"]
