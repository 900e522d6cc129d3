#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine
with a CUDA card (it exits non-zero without one, and prints no result).
It imports nothing of JAX or of the JAX package. Phases, in order; any
failure exits non-zero:

1. Print the card's name and power limit and build every kernel of the
   serving path from ``aldi_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together), with the build time and the compiler's register and
   spill report.
2. Kernel phase: the ROIAlign forward kernel against its plain PyTorch
   version at the flagship's shapes (8 images, 1000 boxes each, p2..p5 of a
   1024x2048 canvas, 256 channels), in float32 and in bfloat16, with boxes
   of every level, some out of range and some invalid; its time, the plain
   version's time and the least time the card could take.
3. Serving phase: the flagship detector (Faster R-CNN R50-FPN,
   ``configs/cityscapes/ALDI-Best-Cityscapes.yaml``: 8 classes, canvas
   1024x2048, bfloat16) with seeded random weights answers one warm-up
   request and then 3 timed requests of 8 synthetic images each, through
   ``build_detector`` and ``make_serving_fn``. The launch counts are set
   to 0 just before the timed requests and read just after. The outputs
   are checked, the kernel is held against its plain version on the last
   request's real proposals and features, a tiny float32 detector on the
   card is held against the same detector on the CPU, one request is timed
   stage by stage, and one is traced with torch.profiler for the device's
   busy share.
4. Print the card line, a ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Kernel times come from CUDA events over repeated launches; request times
from the host clock around work that ends in ``torch.cuda.synchronize()``.
"""

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "cityscapes",
                        "ALDI-Best-Cityscapes.yaml")
BATCH = 8  # the evaluator's default batch size
TIMED_REQUESTS = 3
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): device
# memory 3.35 TB/s; float32 on the CUDA cores 67 TFLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
ROI_STRIDES = [4, 8, 16, 32]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=2):
    """Mean time of one call on the card, from CUDA events around
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roi_bound(features, boxes, levels, output_size=7, sampling_ratio=2):
    """Least time (ms) the card could take for this ROIAlign call, and what
    sets it: bytes (each feature row that this call's samples touch read
    once, boxes and levels read once, the output written once) over the
    memory rate, against float32 operations (4 corner products and 4 sums
    per sample and channel that reads features) over the CUDA-core rate."""
    import torch

    from aldi_tpu_torch.ops.roi_align import sample_geometry

    b, p = boxes.shape[:2]
    c = features[0].shape[-1]
    esize = features[0].element_size()
    hws = [(int(f.shape[1]), int(f.shape[2])) for f in features]
    rows = samples = 0
    for i in range(b):
        idx4, _, ok = sample_geometry(boxes[i], levels[i], hws, ROI_STRIDES,
                                      output_size, sampling_ratio)
        rows += torch.unique(torch.cat([idx[ok] for idx in idx4])).numel()
        samples += int(ok.sum())
    n_bytes = (rows * c * esize + b * p * output_size ** 2 * c * esize
               + boxes.numel() * 4 + levels.numel() * 4)
    ops = samples * c * 8
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_roi(name, features, boxes, levels, plain_iters=3, kernel_iters=20):
    """Hold the kernel against its plain version on these inputs and time
    both. Returns a dict of the numbers; fails the run on disagreement."""
    import torch

    from aldi_tpu_torch.ops.roi_align import roi_align_plain
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd

    got = roi_align_fwd(features, boxes, levels, ROI_STRIDES)
    want = roi_align_plain(features, boxes, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if features[0].dtype == torch.float32:
        tol = 1e-5 * max(1.0, want.float().abs().max().item())
        ok = err <= tol
        tol_text = f"{tol:.3g} (float32: 1e-5 of the output scale)"
    else:  # one bf16 ulp of each value
        ok = bool((diff <= want.float().abs() * 2.0 ** -7 + 1e-6).all())
        tol_text = "one bfloat16 ulp of each value (2^-7 relative)"
    ms = cuda_ms(lambda: roi_align_fwd(features, boxes, levels, ROI_STRIDES),
                 kernel_iters)
    plain_ms = cuda_ms(
        lambda: roi_align_plain(features, boxes, levels, ROI_STRIDES),
        plain_iters, warmup=1)
    bound_ms, bound_by = roi_bound(features, boxes, levels)
    per_level = torch.bincount(levels[levels >= 0].flatten().long(),
                               minlength=len(features)).tolist()
    print(f"[kernel] {name}: boxes {tuple(boxes.shape[:2])}, valid per level "
          f"p2..p5 {per_level}"
          f" dtype {str(features[0].dtype).split('.')[-1]}: max abs err "
          f"{err:.3g}, tolerance {tol_text}: {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f}"
          f" ms ({bound_by})", flush=True)
    if not ok:
        fail(f"roi_align_fwd disagrees with its plain version ({name})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def synthetic_roi_inputs(dtype, seed, b=BATCH, p=1000, c=256,
                         canvas=(1024, 2048)):
    """Flagship-shaped ROIAlign inputs made on the card from a seed: boxes
    of every pyramid level (sqrt-area 8..1400 px, aspect 1:e..e:1), 3%
    wholly out of the canvas, 10% invalid."""
    import torch

    from aldi_tpu_torch.ops.roi_align import box_levels

    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi, shape):
        return torch.rand(shape, generator=g, device="cuda") * (hi - lo) + lo

    feats = [torch.randn((b, canvas[0] // s, canvas[1] // s, c), generator=g,
                         device="cuda").to(dtype) for s in ROI_STRIDES]
    side = torch.exp(u(2.08, 7.24, (b, p)))
    aspect = torch.exp(u(-1.0, 1.0, (b, p)))
    w, h = side * aspect, side / aspect
    cx, cy = u(-64, canvas[1] + 64, (b, p)), u(-64, canvas[0] + 64, (b, p))
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    far = u(0, 1, (b, p)) < 0.03
    boxes[far] = boxes[far] - 4096.0
    valid = u(0, 1, (b, p)) > 0.10
    return feats, boxes.contiguous(), box_levels(boxes, valid, ROI_STRIDES)


def synthetic_request(gen, canvas):
    """One request: BATCH images of uniform noise in 0..255 on the card and
    their valid sizes (most full-canvas, two smaller)."""
    import torch

    images = torch.rand((BATCH, canvas[0], canvas[1], 3), generator=gen,
                        device="cuda") * 255.0
    sizes = torch.tensor([list(canvas)] * BATCH, dtype=torch.int32)
    sizes[1] = torch.tensor([canvas[0] - 124, canvas[1] - 248])
    sizes[5] = torch.tensor([canvas[0], canvas[1] * 3 // 4])
    return images, sizes.cuda()


def seeded_weights(det, seed):
    """A state dict for ``det`` drawn from ``seed`` on the CPU, conditioned
    so that a random network behaves like a trained one in the ways the
    serving path cares about: kernels with std gain/sqrt(fan_in), FrozenBN
    statistics near the identity and a small scale on each bottleneck's
    last conv, so activations stay O(1) through all 50 layers; small box
    deltas, so proposals and detections are varied boxes; spread class
    logits, so detections pass the score threshold and fill the top-100.
    (The JAX package's initializers, which ``init_variables`` mirrors, let a
    random R50 saturate: one detection per image on a degenerate box.)"""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    gains = {"stem.conv1": 1 / 64, "anchor_deltas": 0.1, "bbox_pred": 0.1,
             "cls_score": 3.0}
    out = {}
    for name, t in det.module.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight" and t.dim() > 1:
            g = next((v for k, v in gains.items() if mod.endswith(k)), 1.0)
            x = torch.randn(t.shape, generator=gen) * (
                g / math.sqrt(t[0].numel()))
        elif leaf == "weight" and mod.endswith("conv3.norm"):
            x = torch.rand(t.shape, generator=gen) * 0.2 + 0.1
        elif leaf in ("weight", "running_var"):
            x = torch.rand(t.shape, generator=gen) + 0.5
        else:
            x = torch.randn(t.shape, generator=gen) * 0.05
        out[name] = x
    return out


def check_detections(out, sizes, num_classes, max_det):
    """Finite values of the expected shape; valid boxes inside their
    image, classes in range."""
    import torch

    b = sizes.shape[0]
    shapes = {"boxes": (b, max_det, 4), "scores": (b, max_det),
              "classes": (b, max_det), "valid": (b, max_det)}
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            fail(f"{k} has shape {tuple(out[k].shape)}, expected {s}")
    v = out["valid"]
    bx = out["boxes"]
    if not (torch.isfinite(bx[v]).all() and torch.isfinite(out["scores"][v])
            .all()):
        fail("non-finite detections")
    if torch.isfinite(out["scores"][~v]).any():
        fail("invalid rows carry finite scores")
    h = sizes[:, 0, None].float().expand_as(v)[v]
    w = sizes[:, 1, None].float().expand_as(v)[v]
    x0, y0, x1, y1 = bx[v].unbind(-1)
    if not ((x0 >= 0) & (y0 >= 0) & (x1 <= w) & (y1 <= h) & (x1 > x0)
            & (y1 > y0)).all():
        fail("a valid box lies outside its image")
    c = out["classes"][v]
    if not ((c >= 0) & (c < num_classes)).all():
        fail("class id out of range")
    return int(v.sum())


def tiny_reference_check():
    """A tiny float32 detector (depth 26, canvas 128, 3 classes) on the card
    against the same detector on the CPU, both with ``seeded_weights``,
    TF32 off: detections agree where valid (boxes 1e-3 px, scores 1e-4)."""
    import numpy as np
    import torch

    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.RESNETS.DEPTH = 26
    cfg.TPU.CANVAS = (128, 128)
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    sizes = np.asarray([[128, 128], [100, 120]], np.int32)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_detector(cfg, device="cpu")
    weights = seeded_weights(cpu, seed=0)
    try:
        want = make_serving_fn(cpu, weights)(images, sizes)
        got = {k: v.cpu() for k, v in make_serving_fn(
            build_detector(cfg), weights)(images, sizes).items()}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    m = want["valid"]
    if not torch.equal(got["valid"], m) or not m.any():
        fail("tiny detector: valid detections differ between card and CPU")
    box_err = (got["boxes"][m] - want["boxes"][m]).abs().max().item()
    score_err = (got["scores"][m] - want["scores"][m]).abs().max().item()
    same_cls = torch.equal(got["classes"][m], want["classes"][m])
    print(f"[reference] tiny float32 detector, card vs CPU: {int(m.sum())} "
          f"detections, boxes max abs err {box_err:.3g} (tol 1e-3), scores "
          f"{score_err:.3g} (tol 1e-4), classes equal: {same_cls}", flush=True)
    if box_err > 1e-3 or score_err > 1e-4 or not same_cls:
        fail("tiny detector: card and CPU disagree")


def staged_request(det, images, sizes):
    """One request with a synchronize after each stage: ms per stage."""
    import torch

    from aldi_tpu_torch.models.roi_heads import box_pooler, fast_rcnn_inference

    stages = {}
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - t) * 1e3
        t = now

    with torch.inference_mode():
        x = det.preprocess(images)
        mark("preprocess")
        feats = det.backbone(x)
        mark("backbone (R50 + FPN)")
        logits, deltas = det.rpn_head(feats)
        mark("rpn head")
        pboxes, _, pvalid = det.proposals(logits, deltas, sizes)
        mark("proposals (top-k, decode, NMS)")
        pooled = box_pooler([f.contiguous() for f in feats[:-1]], pboxes,
                            pvalid, det.roi_strides, det.pooler_resolution)
        mark("box pooler (roi_align_fwd)")
        b, s = pooled.shape[:2]
        heads = det.module.roi_heads
        x = heads["box_head"](pooled.reshape((b * s,) + pooled.shape[2:]))
        cls, reg = heads["box_predictor"](x)
        mark("box head")
        r = det.cfg.MODEL.ROI_HEADS
        fast_rcnn_inference(
            pboxes, pvalid, cls.reshape(b, s, -1), reg.reshape(b, s, -1),
            sizes, det.num_classes, score_thresh=r.SCORE_THRESH_TEST,
            nms_thresh=r.NMS_THRESH_TEST,
            topk_per_image=det.cfg.TEST.DETECTIONS_PER_IMAGE,
            box_reg_weights=det.box_reg_weights)
        mark("fast r-cnn inference (decode, NMS)")
    return stages


def device_busy(fn, images, sizes):
    """Trace one request with torch.profiler. Returns the device's busy time
    in ms (the union of its kernel and copy intervals) and the six kernels
    with the most time (name, ms, calls), or None when the trace holds no
    device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(images, sizes)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    return busy_us / 1e3, [(k, ms, n) for k, (ms, n) in top]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(ROOT, "aldi_tpu_torch")) or \
            not os.path.exists(FLAGSHIP):
        fail("run from a checkout of the repository: aldi_tpu_torch/ or the "
             "flagship config is missing")
    sys.path.insert(0, ROOT)
    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.engine.export import make_serving_fn
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.ops import _build
    from aldi_tpu_torch.ops.roi_align import box_levels
    from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd

    kernels = [roi_align_fwd]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = card[0] if card else "unknown"
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # -- 1. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    logs = _build.build([k.name for k in kernels])
    print(f"[build] {len(logs)} of {len(kernels)} kernel libraries compiled "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # -- 2. kernel phase at the flagship's shapes
    for dtype, seed in ((torch.float32, 11), (torch.bfloat16, 12)):
        feats, boxes, levels = synthetic_roi_inputs(dtype, seed)
        check_roi("flagship shapes, synthetic boxes", feats, boxes, levels)
        del feats, boxes, levels
    torch.cuda.empty_cache()

    # -- 3. serving phase: the flagship detector through its entry points
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    t0 = time.perf_counter()
    det = build_detector(cfg)
    fn = make_serving_fn(det, seeded_weights(det, seed=0))
    torch.cuda.synchronize()
    print(f"[serving] R{cfg.MODEL.RESNETS.DEPTH}-FPN, {det.num_classes} "
          f"classes, canvas {det.canvas}, {str(det.dtype).split('.')[-1]}; "
          f"built and seeded in {time.perf_counter() - t0:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    requests = [synthetic_request(gen, det.canvas)
                for _ in range(1 + TIMED_REQUESTS)]
    t0 = time.perf_counter()
    out = fn(*requests[0])
    torch.cuda.synchronize()
    print(f"[serving] warm-up request: {(time.perf_counter() - t0) * 1e3:.1f}"
          f" ms", flush=True)

    for k in kernels:
        k.launches = 0
    latencies, n_det = [], 0
    for images, sizes in requests[1:]:
        t0 = time.perf_counter()
        out = fn(images, sizes)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        n_det += check_detections(out, sizes, det.num_classes,
                                  cfg.TEST.DETECTIONS_PER_IMAGE)
    launches = {k.name: k.launches for k in kernels}
    for name, n in launches.items():
        if n == 0:
            fail(f"the serving path never launched {name}")
    if n_det == 0:
        fail("no valid detections in any request")
    lat = sorted(latencies)
    print(f"[serving] {TIMED_REQUESTS} requests of {BATCH} images: latency ms "
          f"{', '.join(f'{x:.2f}' for x in latencies)} (median "
          f"{lat[len(lat) // 2]:.2f}), {BATCH * 1e3 / lat[len(lat) // 2]:.2f} "
          f"images/s at the median; {n_det} valid detections; launches "
          f"{launches}; card {card}", flush=True)

    # the kernel on the last request's real proposals and features
    images, sizes = requests[-1]
    with torch.inference_mode():
        feats = det.backbone(det.preprocess(images))
        logits, deltas = det.rpn_head(feats)
        pboxes, _, pvalid = det.proposals(logits, deltas, sizes)
    feats = [f.contiguous() for f in feats[:-1]]
    pboxes = pboxes.float().contiguous()
    levels = box_levels(pboxes, pvalid, det.roi_strides)
    real = check_roi("serving request, real proposals", feats, pboxes, levels)
    del feats, logits, deltas

    stages = staged_request(det, images, sizes)
    print("[serving] one request by stage (ms, synchronized): "
          + "; ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    print(f"[serving] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    traced = device_busy(fn, images, sizes)
    if traced is None:
        print("[serving] device busy share: not measured (the profiler saw "
              "no device events)")
    else:
        busy, top = traced
        median = lat[len(lat) // 2]
        print(f"[serving] traced request: device busy {busy:.2f} ms of the "
              f"{median:.2f} ms median request, idle share "
              f"{max(0.0, 1 - busy / median):.3f}; top kernels: "
              + "; ".join(f"{k[:60]} {ms:.2f} ms x{n}" for k, ms, n in top),
              flush=True)
    del det, fn, requests, out
    torch.cuda.empty_cache()

    tiny_reference_check()

    # -- 4. result lines
    print(f"[card] {card}")
    entries = [{
        "name": k.name, "route": "cuda", "source": k.source,
        "replaces": k.replaces, "launches": launches[k.name],
        "max_abs_err": real["max_abs_err"], "ms": real["ms"],
        "plain_ms": real["plain_ms"], "bound_ms": real["bound_ms"],
        "bound_by": real["bound_by"], "library_ms": None,
    } for k in kernels]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except Exception:  # any phase that raised fails the run
        traceback.print_exc()
        fail("a phase raised")
