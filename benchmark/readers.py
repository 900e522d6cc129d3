"""What the metric readers (``metrics/<metric>.py``) share. A reader's
``read(rec)`` takes a run's record and returns a number, or None where the
run has nothing to read (an untraced run, a cell without the kernel).

A record holds ``setup_s``; ``window_s``, ``steps`` or ``requests``,
``images`` and ``latencies_ms`` of the measured window; ``flops``, the
operations of one step or request (``flops/<config>.py``); and, from a
traced run, ``trace`` (``trace.reduce``), ``stage_ms`` (per step, each
stage's milliseconds between CUDA events at the ``mark`` hook) and
``launches`` (the port's kernel launches with their inputs)."""

from .bounds import flash_attn, match, peaks, roi_align
from .trace import kernel_seconds


def rate(rec):
    if "window_s" not in rec or not rec["images"]:
        return None
    return rec["images"] / rec["window_s"]


def mfu(rec, units_key):
    """The window's operations over its length and the bf16 peak, in %."""
    t = rec.get("trace")
    if not t or not rec.get(units_key):
        return None
    return 100.0 * rec["flops"] * rec[units_key] / t["window_s"] \
        / peaks.BF16_FLOPS


def idle_share(rec):
    t = rec.get("trace")
    if not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def stage_ms(rec, match_stage):
    """Mean per step of the summed ms of the stages ``match_stage``
    accepts."""
    steps = rec.get("stage_ms")
    if not steps:
        return None
    per = [sum(ms for name, ms in step if match_stage(name))
           for step in steps]
    return sum(per) / len(per)


def launch_bound_s(kind, r) -> float:
    if kind in ("match_iou", "low_quality_mask"):
        return match.bound_s(kind, r["anchors"], r["gt"], r["valid"],
                             r.get("best"))
    if kind == "roi_align_fwd":
        return roi_align.fwd_bound_s(r["hws"], r["channels"], r["esize"],
                                     r["boxes"], r["levels"])
    if kind == "roi_align_bwd":
        return roi_align.bwd_bound_s(r["grad_shape"], r["esize"],
                                     r["boxes"], r["levels"], r["hws"])
    g, n, d = r["shape"]
    return flash_attn.bound_s("fwd" if kind == "flash_attn_fwd" else "bwd",
                              g, n, d, r["esize"], r["h_grid"], r["w_grid"],
                              r["bf16"])


def roofline(rec, kinds):
    """The launches' bounds over their kernels' device time, in %."""
    t, launches = rec.get("trace"), rec.get("launches")
    if not t or not launches:
        return None
    bound = sum(launch_bound_s(k, r) for k, r in launches if k in kinds)
    busy = sum(kernel_seconds(t, k) for k in kinds)
    if bound == 0 or busy == 0:
        return None
    return 100.0 * bound / busy
