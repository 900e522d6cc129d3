"""The traced window: ``torch.profiler`` over the window's calls, the
port's kernel launches recorded around their wrappers, CUDA events at the
step's ``mark`` hook, and the trace reduced to what the metric readers
read (device intervals, kernel times, copies, idle gaps)."""

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "benchmark.window"
MARK = "benchmark.mark: "

# the port's kernel wrappers: (module, attribute, kind); the custom ops'
# cuda implementations look each up at call time
WRAPPERS = (("aldi_tpu_torch.ops.match_kernel", "match_iou", "match_iou"),
            ("aldi_tpu_torch.ops.match_kernel", "low_quality_mask",
             "low_quality_mask"),
            ("aldi_tpu_torch.ops.roi_align_kernel", "roi_align_fwd",
             "roi_align_fwd"),
            ("aldi_tpu_torch.ops.roi_align_kernel", "roi_align_bwd",
             "roi_align_bwd"),
            ("aldi_tpu_torch.ops.flash_attn_kernel", "flash_attn_fwd",
             "flash_attn_fwd"),
            ("aldi_tpu_torch.ops.flash_attn_kernel", "flash_attn_bwd",
             "flash_attn_bwd"))

# the device kernels of each launch kind (substrings of their names)
KERNELS = {"match_iou": ("match_iou_kernel",),
           "low_quality_mask": ("low_quality_kernel",),
           "roi_align_fwd": ("roi_align_fwd_kernel",),
           "roi_align_bwd": ("roi_bins_kernel", "roi_tiles_kernel"),
           "flash_attn_fwd": ("flash_attn_fwd",),
           "flash_attn_bwd": ("flash_attn_bwd",)}


def _record(kind, args):
    """What a launch's bound needs: small inputs cloned (asynchronously),
    large ones by shape."""
    def c(t):
        return t.detach().clone()

    if kind in ("match_iou", "low_quality_mask"):
        rec = {"anchors": args[0], "gt": c(args[1]), "valid": c(args[2])}
        if kind == "low_quality_mask":
            rec["best"] = c(args[3])
        return rec
    if kind == "roi_align_fwd":
        feats, boxes, levels = args[:3]
        return {"hws": [(int(f.shape[1]), int(f.shape[2])) for f in feats],
                "channels": int(feats[0].shape[-1]),
                "esize": feats[0].element_size(), "boxes": c(boxes),
                "levels": c(levels)}
    if kind == "roi_align_bwd":
        grad, boxes, levels, hws = args[:4]
        return {"grad_shape": tuple(grad.shape), "esize": grad.element_size(),
                "boxes": c(boxes), "levels": c(levels),
                "hws": [tuple(int(v) for v in hw) for hw in hws]}
    q, h_grid, w_grid = args[0], args[-2], args[-1]
    return {"shape": tuple(q.shape), "esize": q.element_size(),
            "bf16": q.dtype.is_floating_point and q.element_size() == 2,
            "h_grid": int(h_grid), "w_grid": int(w_grid)}


class Launches:
    """Records every launch of the port's kernels while active."""

    def __init__(self):
        self.records = []
        self.saved = []

    def __enter__(self):
        import importlib

        for mod_name, attr, kind in WRAPPERS:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapped(*args, _orig=orig, _kind=kind):
                self.records.append((_kind, _record(_kind, args)))
                return _orig(*args)

            self.saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        self.saved = []


class _HostEvent:
    """A CPU run's stand-in for a CUDA event (the benchmark's own tests)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _event(device):
    import torch

    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


class StageEvents:
    """CUDA events at the step's start and at each ``mark`` call, without a
    synchronisation; ``stage_ms()`` reads them after the window."""

    def __init__(self, device):
        self.device = device
        self.steps = []

    def start(self):
        ev = _event(self.device)
        ev.record()
        self.steps.append([("start", ev)])

    def mark(self, name):
        import torch

        ev = _event(self.device)
        ev.record()
        with torch.profiler.record_function(MARK + name):
            pass
        self.steps[-1].append((name, ev))

    def stage_ms(self) -> list:
        """Per step: [(stage, ms from the previous event)]."""
        _sync(self.device)
        return [[(name, prev.elapsed_time(ev))
                 for (_, prev), (name, ev) in zip(step, step[1:])]
                for step in self.steps]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


class Window:
    """``with Window(device) as w: ...`` profiles the calls inside it (CPU
    and CUDA activity, the window as one annotation) into a chrome trace
    under TMPDIR, read back and deleted on exit."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch

        _sync(self.device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.annotation = torch.profiler.record_function(WINDOW)
        self.annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.seconds = time.perf_counter() - self.t0
        self.annotation.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        del self.prof


def reduce(events) -> dict:
    """The window's device intervals (merged), kernel seconds by name,
    copies, marks and host calls, from chrome-trace events."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        return {}
    w0 = min(float(e["ts"]) for e in win)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in win)
    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            s = max(float(e["ts"]), w0)
            t = min(float(e["ts"]) + float(e["dur"]), w1)
            if t > s:
                dev.append((s, t, e["name"], e["cat"]))
    dev.sort()
    merged = []
    for s, t, _, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    kernel_s = {}
    for s, t, name, cat in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (t - s) * 1e-6
    marks = sorted((float(e["ts"]), e["name"][len(MARK):]) for e in xs
                   if str(e.get("name", "")).startswith(MARK))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs if e.get("cat") == "cpu_op")
    return {"window_s": (w1 - w0) * 1e-6, "start_us": w0, "end_us": w1,
            "busy_s": sum(t - s for s, t in merged) * 1e-6,
            "merged": merged, "device": dev, "kernel_s": kernel_s,
            "marks": marks, "host": host}


def idle_gaps(red, top=10) -> list:
    """The longest gaps without device work in the window, each named by
    what the host was doing as it began: the stage after the last mark (a
    training step's) and the innermost host call then running."""
    w0, w1, merged = red["start_us"], red["end_us"], red["merged"]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    out = []
    for dur, at in gaps:
        last = [name for ts, name in red["marks"] if ts <= at]
        calls = [(s, name) for s, e, name in red["host"] if s <= at < e]
        label = (f"after {last[-1]}: " if last else "") + (
            max(calls)[1] if calls else "host")
        out.append([label, dur * 1e-6])
    return out


def top_device_ops(red, top=10) -> list:
    return sorted(([name, s] for name, s in red["kernel_s"].items()),
                  key=lambda x: -x[1])[:top]


def kernel_seconds(red, kind) -> float:
    return sum(s for name, s in red["kernel_s"].items()
               if any(k in name for k in KERNELS[kind]))
