"""Traffic ``serve``: requests through ``make_serving_fn``'s ``fn``,
closed loop with one client. Each request is ``request_images`` noise
images at the canvas in float32 with their sizes, taken in turn from a pool
of ``pool`` distinct requests made from the seed and held in pinned host
memory: the copy to the card is part of each request, as in the
evaluator's ``device_inputs``. A request's latency runs on the host clock
from the call until its outputs are synchronised on the card.

After the window ``check_requests`` of the requests it finished, drawn
from the seed (the latest of them always among them), are read by the
plain reference on the same images: the served scores, and the served
set against the reference's own detections (``compare``).

Workload parameters: ``request_images``, ``cut`` (one image a request
that much smaller than the canvas), ``pool``, ``warmup``,
``check_requests``, ``traced_requests``."""

import gc
import random
import time

from .. import compare, harness, inputs, trace
from ..reference import runner

OUTPUTS = ("boxes", "scores", "classes", "valid")


def make_pool(canvas, w, seed, device, count):
    """``count`` requests: (images, sizes) on the host (pinned where the
    device is a card), made on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(
        seed + harness.INPUT_STREAM)
    pool = []
    for _ in range(count):
        images, sizes = inputs.request(gen, w, canvas)
        pin = device.type == "cuda"
        pool.append((images.cpu().pin_memory() if pin else images.cpu(),
                     sizes.cpu()))
    return pool


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def program_run(cell, seed, seconds, traced, device, t0, fault=None):
    import torch

    from aldi_tpu_torch.config import resolve_canvas
    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector

    w = cell.workload
    cfg = harness.program_cfg(cell)
    canvas = resolve_canvas(cfg)
    det = build_detector(cfg, device=device)
    weights = harness.conditioned_weights(harness.shapes_of(det.module),
                                          seed, device)
    fn = make_serving_fn(det, weights)
    del weights
    if fault is not None:
        fn = fault(fn)
    pool = make_pool(canvas, w, seed, device, w["pool"])
    for i in range(w["warmup"]):
        fn(*pool[i % len(pool)])
    sync(device)
    rec = {"setup_s": time.perf_counter() - t0,
           "images_per_request": w["request_images"],
           "flops": cell.flops().request(cfg, w["request_images"])}
    outs, latencies = [], []
    limit = w["traced_requests"] if traced else None

    def window():
        start = time.perf_counter()
        n = 0
        while (time.perf_counter() - start < seconds
               and (limit is None or n < limit)):
            k = n % len(pool)
            t = time.perf_counter()
            if traced:
                with torch.profiler.record_function("request"):
                    out = fn(*pool[k])
            else:
                out = fn(*pool[k])
            sync(device)
            latencies.append((time.perf_counter() - t) * 1e3)
            outs.append((k, out))
            n += 1
        return start, n

    if traced:
        with trace.Launches() as launches, trace.Window(device) as win:
            start, n = window()
        rec.update(trace=trace.reduce(win.events),
                   launches=launches.records)
    else:
        start, n = window()
        rec["window_s"] = time.perf_counter() - start
    rec.update(requests=n, images=n * w["request_images"],
               latencies_ms=latencies,
               memory_peak_bytes=(torch.cuda.max_memory_allocated()
                                  if device.type == "cuda" else 0))
    rng = random.Random(seed)
    picked = sorted(set(rng.sample(range(n), min(w["check_requests"], n)))
                    | {n - 1})
    checked = [(outs[i][0], {k: v.cpu() for k, v in outs[i][1].items()})
               for i in picked]
    return checked, rec, cfg, canvas


def reference_check(cell, seed, device, served, products="float32"):
    """The reference's readings of ``served`` [(pool index, detections)]
    (``compare``): its score of each served detection, and the served set
    against its own detections of the same request. With ``products``
    "fp8" the control's detections of those requests take the served
    ones' place."""
    import torch

    w = cell.workload
    cfg = runner.config(cell.yaml(), cell.overrides())
    from ..reference.config import resolve_canvas

    canvas = resolve_canvas(cfg)
    det = runner.detector(cfg, device)
    weights = harness.conditioned_weights(harness.shapes_of(det.module),
                                          seed, device)
    pool = make_pool(canvas, w, seed, device, max(k for k, _ in served) + 1)
    nms = cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST

    def cpu(dets):
        return {n: v.cpu() for n, v in dets.items() if n != "candidates"}

    tally = dict.fromkeys(("read", "off", "best", "missed", "served",
                           "duplicates"), 0)
    widest = count_gap = 0.0
    profile_p, profile_r = [], []
    for k in sorted({k for k, _ in served}):
        images, sizes = (t.to(device) for t in pool[k])
        ref = cpu(runner.detect(det, weights, images, sizes))
        outs = [out for key, out in served if key == k]
        if products != "float32":
            outs = [cpu(runner.detect(det, weights, images, sizes,
                                      products))]
        for out in outs:
            rescored, margin = runner.rescore(
                det, weights, images, sizes,
                *(out[n].to(device) for n in ("boxes", "classes", "valid")))
            r = compare.serve_readings(out, rescored.cpu(), margin.cpu(),
                                       sizes.cpu())
            r.update(compare.detection_set(out, ref, nms))
            for name in tally:
                tally[name] += r[name]
            widest = max(widest, r["score_gap"])
            count_gap = max(count_gap, r["count_gap"])
            profile_p.append(compare.sorted_scores(out["scores"],
                                                   out["valid"]))
            profile_r.append(compare.sorted_scores(ref["scores"],
                                                   ref["valid"]))
    readings = {
        "score_off_share": (tally["off"] / tally["read"] if tally["read"]
                            else 1.0),
        "score_gap": widest, "scores_read": float(tally["read"]),
        "count_gap": count_gap,
        "miss_share": tally["missed"] / max(tally["best"], 1),
        "best_read": float(tally["best"]),
        "duplicate_share": tally["duplicates"] / max(tally["served"], 1),
        "profile_gap": compare.score_profile_gap(profile_p, profile_r)}
    del det, weights, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return readings


def run(cell, seed, seconds, traced, device, t0, fault=None):
    import torch

    checked, rec, _, _ = program_run(cell, seed, seconds, traced, device, t0,
                                     fault)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["readings"] = reference_check(cell, seed, device, checked)
    rec["attempted"] = rec["requests"]
    rec["failed"] = 0
    return rec
