"""The port's profiler ranges in a traced window: ``aldi/<stage>`` around a
stage's work and ``aldi/sync/<site>`` around a place where the host waits
on the device (``aldi_tpu_torch/utils/tracing.py``).

The ranges are ``cpu_op`` events, so ``trace.reduce`` keeps them in the
record's ``host`` list [(start, end, name)], on the device intervals'
clock. The readers of ``metrics/`` read them from there through ``per``,
which gives None where the window holds no ``aldi/`` range (a program
without them) or no device interval (a run on the CPU).

``span_busy`` reads the device work launched inside each range from the
Chrome trace itself (a kernel, copy or memset belongs to the range whose
thread launched it inside the range, by the runtime call's
``correlation``); ``trace.reduce`` keeps no correlation, so no reader can
use it yet."""

import bisect

from . import trace

PREFIX = "aldi/"
SYNC = "aldi/sync/"
NMS = "aldi/nms"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def ranges(red, match) -> list:
    """(start, end) of the window's ranges whose name ``match`` accepts."""
    return [(s, e) for s, e, name in red.get("host", ()) if match(name)]


def count(red, match) -> int:
    return len(ranges(red, match))


def gaps(red) -> list:
    """(start, end) of the window's gaps without device work."""
    edges = ([red["start_us"]] + [x for iv in red["merged"] for x in iv]
             + [red["end_us"]])
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_opening_in(red, match) -> float:
    """Seconds of the gaps that open while a range ``match`` accepts is
    open: the device ran dry there and waited until the next launch."""
    rs = sorted(ranges(red, match))
    starts = [s for s, _ in rs]
    idle = 0.0
    for a, b in gaps(red):
        k = bisect.bisect_right(starts, a)
        if any(s <= a < e for s, e in rs[:k]):
            idle += b - a
    return idle * 1e-6


def per(rec, units, value):
    """``value(trace)`` per step or request (``units``: ``steps`` or
    ``requests``) of a traced window, or None without ranges or device
    intervals."""
    t = rec.get("trace")
    if (not t or not t.get("merged") or not rec.get(units)
            or not any(name.startswith(PREFIX)
                       for _, _, name in t.get("host", ()))):
        return None
    return value(t) / rec[units]


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, t in sorted(intervals):
        if t > end:
            total += t - max(s, end)
            end = t
    return total


def _launches(xs):
    """({correlation: [device interval]}, {(pid, tid): sorted [(launch
    time, correlation)]}) of Chrome-trace events ``xs``."""
    device = {}
    for e in xs:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in trace.DEVICE_CATS and c is not None:
            s = float(e["ts"])
            device.setdefault(c, []).append((s, s + float(e["dur"])))
    launches = {}
    for e in xs:
        c = e.get("args", {}).get("correlation")
        if e.get("cat") in RUNTIME_CATS and c in device:
            launches.setdefault((e.get("pid"), e.get("tid")), []).append(
                (float(e["ts"]), c))
    for v in launches.values():
        v.sort()
    return device, launches


def span_busy(events, prefix=PREFIX) -> list:
    """Per range of the Chrome-trace ``events`` whose name starts with
    ``prefix``: [host start, host end, name, device busy seconds], the
    busy seconds the union of the device intervals of the kernels, copies
    and memsets launched inside it on its thread."""
    xs = [e for e in events if e.get("ph") == "X"]
    device, launches = _launches(xs)
    out = []
    for e in xs:
        name = str(e.get("name", ""))
        if (e.get("cat") not in ("cpu_op", "user_annotation")
                or not name.startswith(prefix)):
            continue
        s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        seq = launches.get((e.get("pid"), e.get("tid")), [])
        lo = bisect.bisect_left(seq, (s, -1))
        hi = bisect.bisect_right(seq, (t, float("inf")))
        ivs = [iv for _, c in seq[lo:hi] for iv in device[c]]
        out.append([s, t, name, _union(ivs) * 1e-6])
    return sorted(out, key=lambda r: r[:3])
