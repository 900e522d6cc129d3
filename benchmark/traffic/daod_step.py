"""Traffic ``daod_step``: the ALDI++ DAOD step of ``make_train_step``,
closed loop, step after step, on a pool of distinct batches and draws made
on the device from the seed.

Set-up builds one training state from the seed's weights and drives it
through the first ``check_steps`` steps (the window's own call and feed,
on batches that all differ), recording each step's loss, each trainable
leaf's gradient of the first step, its change over them in the student and
in the EMA teacher, and the detections of each teacher pass; the window
then runs on that state. After the window and the reading of the peak
memory the program is freed and the plain reference follows the same
steps from the same weights, batches and draws.

Workload parameters: ``n_labeled``, ``n_unlabeled`` (images a step),
``gt_count`` and ``gt_side`` (gt boxes an image and their sides, px),
``cut`` (one image a batch that much smaller than the canvas),
``pool`` (distinct batches), ``check_steps``, ``traced_steps`` (at most
that many steps in the traced window)."""

import gc
import time

from .. import compare, harness, inputs, trace
from ..reference import runner


def make_pool(cfg, canvas, w, seed, device, count):
    import torch

    gen = torch.Generator(device=device).manual_seed(
        seed + harness.INPUT_STREAM)
    pool = []
    for _ in range(count):
        batch = inputs.daod_batch(gen, w, canvas, cfg.TPU.MAX_GT,
                                  cfg.MODEL.ROI_HEADS.NUM_CLASSES)
        pool.append((batch, inputs.daod_draws(gen, cfg, canvas,
                                              w["n_labeled"],
                                              w["n_unlabeled"])))
    return pool


def teacher_view(out: dict, cfg) -> dict:
    """``out`` with its teacher passes' detections (``teacher``) read as
    each pass's detections (``teacher_dets``), its sorted scores and the
    pseudo-labels counted over them (the detections at TEACHER.THRESHOLD
    or above)."""
    threshold = cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD
    seen = out.pop("teacher")
    out["teacher_dets"] = [dict(zip(("boxes", "scores", "classes", "valid"),
                                    d)) for d in seen]
    out["teacher_scores"] = [compare.sorted_scores(s, v)
                             for _, s, _, v in seen]
    out["pseudo"] = [int(((s >= threshold) & v).sum())
                     for _, s, _, v in seen]
    return out


def program_run(cell, seed, seconds, traced, device, t0, fault=None):
    """Set-up, check steps and window of the port. ``fault``, for the
    benchmark's own tests, breaks the timed path underneath."""
    import torch

    from aldi_tpu_torch.config import resolve_canvas
    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  make_train_step)
    from aldi_tpu_torch.models import build_detector

    w = cell.workload
    cfg = harness.program_cfg(cell)
    canvas = resolve_canvas(cfg)
    det = build_detector(cfg, device=device)
    weights = harness.conditioned_weights(harness.shapes_of(det.module),
                                          seed, device)
    state = create_train_state(cfg, det, weights)
    step = make_train_step(cfg, det)
    if fault is not None:
        step = fault(step)
    pool = make_pool(cfg, canvas, w, seed, device, w["pool"])
    trainable = {n: p for n, p in state.student.named_parameters()
                 if p.requires_grad}
    out = {"loss": [], "grad": None, "teacher": []}
    with runner.recording_teacher(det, out["teacher"]):
        for i in range(w["check_steps"]):
            state, metrics = step(state, *pool[i % len(pool)])
            out["loss"].append(float(metrics["total_loss"]))
            if out["grad"] is None:
                out["grad"] = runner.norms({n: (p.grad if p.grad is not None
                                                else torch.zeros_like(p))
                                            for n, p in trainable.items()})
    out["change"] = runner.norms({n: p.detach() - weights[n]
                                  for n, p in trainable.items()})
    teacher = dict(state.teacher.named_parameters())
    out["teacher_change"] = runner.norms({n: teacher[n].detach() - weights[n]
                                          for n in trainable})
    teacher_view(out, cfg)
    del weights, teacher
    sync(device)
    images = w["n_labeled"] + w["n_unlabeled"]
    at = w["check_steps"]
    rec = {"setup_s": time.perf_counter() - t0, "images_per_step": images,
           "flops": cell.flops().step(cfg, w["n_labeled"],
                                      w["n_unlabeled"])}
    if not traced:
        start = time.perf_counter()
        n = 0
        while time.perf_counter() - start < seconds:
            state, _ = step(state, *pool[(at + n) % len(pool)])
            n += 1
        sync(device)
        rec.update(window_s=time.perf_counter() - start, steps=n,
                   images=n * images)
    else:
        stages = trace.StageEvents(device)

        def mark(name):
            stages.mark(name)

        with trace.Launches() as launches, trace.Window(device) as win:
            n = 0
            start = time.perf_counter()
            while (n < w["traced_steps"]
                   and time.perf_counter() - start < seconds):
                stages.start()
                state, _ = step(state, *pool[(at + n) % len(pool)],
                                mark=mark)
                n += 1
        red = trace.reduce(win.events)
        rec.update(steps=n, images=n * images, trace=red,
                   stage_ms=stages.stage_ms(), launches=launches.records)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if device.type == "cuda" else 0)
    return out, rec, cfg, canvas


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def reference_run(cell, seed, device, products="float32"):
    """The reference's first steps of the cell, from the seed."""
    import torch

    w = cell.workload
    cfg = runner.config(cell.yaml(), cell.overrides())
    from ..reference.config import resolve_canvas

    canvas = resolve_canvas(cfg)
    det = runner.detector(cfg, device)
    weights = harness.conditioned_weights(harness.shapes_of(det.module),
                                          seed, device)
    pool = make_pool(cfg, canvas, w, seed, device,
                     min(w["check_steps"], w["pool"]))
    steps = [pool[i % len(pool)] for i in range(w["check_steps"])]
    out = teacher_view(runner.train_steps(cfg, det, weights, steps,
                                          products), cfg)
    del det, weights, pool, steps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell, seed, seconds, traced, device, t0, fault=None):
    """One run of the cell: (readings, record) with the readings of the
    comparison and what the metric readers read."""
    import torch

    prog, rec, cfg, canvas = program_run(cell, seed, seconds, traced, device,
                                         t0, fault)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_run(cell, seed, device)
    rec["readings"] = compare.train_readings(prog, ref)
    rec["attempted"] = rec["steps"]
    rec["failed"] = 0
    return rec
