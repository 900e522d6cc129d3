#!/usr/bin/env python3
"""The synthetic domain-shift benchmark trained end to end through the
port's CLI (``aldi_tpu_torch/tools/train_net.py``): burn-in, then ALDI++
from the burn-in checkpoint's EMA weights, beside source-only training
continued for as long.

The port's copy of ``tests/shift_benchmark.py`` (``make_shift_split``,
the same generator, seeds and splits: shape-coded objects on dark noise
as the source domain; the same process under fog, blur, a color cast and
sensor noise as the target) and the protocol of
``tools/efficacy_experiment.py`` for one seed:

- source-only: ``configs/synthetic/Base-RCNN-FPN-Shift.yaml`` for 2800
  iterations (LR step at 2700), a checkpoint every 1200; its 1200-iteration
  checkpoint is the burn-in;
- ALDI++: ``configs/synthetic/ALDI-Shift.yaml`` from the burn-in
  checkpoint (its EMA entry) for 1600 iterations, at a fixed teacher
  threshold (``--threshold``; the JAX package's seed-0 calibration by
  default).

Each arm's teacher is evaluated (AP50) on ``shift_tgt_val``, the target
domain, and ``shift_src_val``. Run from the repository root:

    python3 -m aldi_tpu_torch.tools.efficacy --out output/efficacy

(``--device cpu`` with small ``--burnin``/``--da-iters`` checks the
plumbing on the CPU). The report is written to ``<out>/efficacy.json``.
"""

import argparse
import gc
import json
import os
import subprocess
import time

import numpy as np
from PIL import Image, ImageFilter

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASE_CFG = os.path.join(REPO, "configs", "synthetic",
                        "Base-RCNN-FPN-Shift.yaml")
ALDI_CFG = os.path.join(REPO, "configs", "synthetic", "ALDI-Shift.yaml")

CLASSES = ["rect", "ring", "cross"]
# the target domain's rendering (tests/shift_benchmark.py SHIFT)
SHIFT = {
    "fog_contrast": (0.30, 0.42),   # arr*c + haze*(1-c), c ~ U(range)
    "fog_haze": 190.0,              # haze gray level
    "color_cast": (1.10, 0.85, 0.70),  # per-channel gain (warm cast)
    "blur_radius": (1.0, 1.8),      # Gaussian blur radius ~ U(range)
    "noise_std": 12.0,              # additive Gaussian sensor noise
}
# split -> (images, generator seed, shifted)
SPLITS = {
    "shift_src_train": (160, 10, False),
    "shift_src_val": (64, 11, False),
    "shift_tgt_train": (256, 12, True),
    "shift_tgt_val": (320, 13, True),
}
# the JAX package's seed-0 calibration of DOMAIN_ADAPT.TEACHER.THRESHOLD
# (EFFICACY.json per_seed["0"]["threshold"])
SEED0_THRESHOLD = 0.3627


def _draw_objects(rng, h, w, max_objects=3):
    """One image (float32 HWC, 0..255) and its boxes and classes."""
    img = rng.uniform(0, 40, (h, w, 3)).astype(np.float32)
    n = int(rng.integers(1, max_objects + 1))
    boxes, classes = [], []
    for _ in range(n):
        bw = int(rng.integers(26, 56))
        bh = int(rng.integers(26, 56))
        x0 = int(rng.integers(0, w - bw))
        y0 = int(rng.integers(0, h - bh))
        c = int(rng.integers(0, 3))
        col = rng.uniform(150, 255, 3)
        if c == 0:  # filled rect
            img[y0:y0 + bh, x0:x0 + bw] = col
        elif c == 1:  # ring
            img[y0:y0 + bh, x0:x0 + bw] = col
            t = max(4, min(bw, bh) // 6)
            img[y0 + t:y0 + bh - t, x0 + t:x0 + bw - t] = 20.0
        else:  # cross
            cy, cx = y0 + bh // 2, x0 + bw // 2
            a = max(3, min(bw, bh) // 8)
            img[cy - a:cy + a, x0:x0 + bw] = col
            img[y0:y0 + bh, cx - a:cx + a] = col
        boxes.append([x0, y0, bw, bh])
        classes.append(c)
    return img, boxes, classes


def _apply_shift(img, rng):
    """Fog, blur, color cast and noise: the target domain's rendering."""
    arr = img * np.asarray(SHIFT["color_cast"], np.float32)
    c = float(rng.uniform(*SHIFT["fog_contrast"]))
    arr = arr * c + SHIFT["fog_haze"] * (1.0 - c)
    pil = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
    pil = pil.filter(ImageFilter.GaussianBlur(
        float(rng.uniform(*SHIFT["blur_radius"]))))
    arr = np.asarray(pil, np.float32)
    arr = arr + rng.normal(0.0, SHIFT["noise_std"], arr.shape)
    return np.clip(arr, 0, 255)


def make_shift_split(root, name, n_images, seed, shifted, size=(128, 128)):
    """Write images and a COCO json under root/name; returns (json,
    image dir)."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, name, "images")
    os.makedirs(img_dir, exist_ok=True)
    h, w = size
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        img, boxes, classes = _draw_objects(rng, h, w)
        if shifted:
            img = _apply_shift(img, rng)
        fname = f"img_{i:04d}.png"
        Image.fromarray(img.astype(np.uint8)).save(
            os.path.join(img_dir, fname))
        images.append(
            {"id": i + 1, "file_name": fname, "height": h, "width": w})
        for (x0, y0, bw, bh), c in zip(boxes, classes):
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": c + 1,
                "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0,
            })
            ann_id += 1
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": c + 1, "name": n} for c, n in enumerate(CLASSES)
        ],
    }
    json_path = os.path.join(root, name, "annotations.json")
    with open(json_path, "w") as f:
        json.dump(coco, f)
    return json_path, img_dir


def register_shift_benchmark(root):
    """Generate (if absent) and register the four splits in the port's
    catalog. Returns the split names."""
    from aldi_tpu_torch.data.catalog import (DatasetCatalog,
                                             register_coco_instances)

    for name, (n, seed, shifted) in SPLITS.items():
        if name in DatasetCatalog:
            continue
        jp = os.path.join(root, name, "annotations.json")
        ir = os.path.join(root, name, "images")
        if not os.path.exists(jp):
            jp, ir = make_shift_split(root, name, n, seed, shifted)
        register_coco_instances(name, {}, jp, ir)
    return list(SPLITS)


def run_cli(config_file, opts, eval_only=False, resume=False):
    """One ``train_net`` run in this process; returns its results."""
    import torch

    from aldi_tpu_torch.tools import train_net

    argv = ["--config-file", config_file]
    argv += ["--eval-only"] if eval_only else []
    argv += ["--resume"] if resume else []
    args = train_net.default_argument_parser().parse_args(
        argv + [str(o) for o in opts])
    results = train_net.main(args)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return results


def _ap50(results):
    return {ds: float(r["bbox/AP50"]) for ds, r in results.items()}


def mean_pseudo_labels(out_dir):
    """Mean ``num_pseudo_labels`` over the run's written iterations; raises
    if it never exceeded 0 (a DA run without pseudo-labels shows
    nothing)."""
    with open(os.path.join(out_dir, "metrics.json")) as f:
        counts = [float(r["num_pseudo_labels"]) for r in map(json.loads, f)
                  if "num_pseudo_labels" in r]
    if not counts or max(counts) <= 0:
        raise RuntimeError(f"no pseudo-labels in {out_dir}: calibrate "
                           "DOMAIN_ADAPT.TEACHER.THRESHOLD")
    return sum(counts) / len(counts)


def card_name():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return None


def run(out_root, seed=0, burnin=1200, da_iters=1600,
        threshold=SEED0_THRESHOLD, device=None):
    register_shift_benchmark(os.path.join(out_root, "data"))
    common = ["SEED", seed] + (["MODEL.DEVICE", device] if device else [])
    base_out = os.path.join(out_root, f"base_s{seed}")
    aldi_out = os.path.join(out_root, f"aldi_s{seed}")
    burnin_ckpt = os.path.join(base_out, f"model_{burnin:07d}.pth")
    total = burnin + da_iters
    res, walls = {}, {}

    t0 = time.time()
    run_cli(BASE_CFG, common + [
        "OUTPUT_DIR", base_out, "SOLVER.MAX_ITER", total,
        "SOLVER.STEPS", f"({total - 100},)",
        "SOLVER.CHECKPOINT_PERIOD", burnin])
    walls["source_only_train_s"] = time.time() - t0
    res["source_only"] = _ap50(run_cli(
        BASE_CFG, common + ["OUTPUT_DIR", base_out], eval_only=True,
        resume=True))
    res["burnin"] = _ap50(run_cli(
        BASE_CFG, common + ["OUTPUT_DIR",
                            os.path.join(out_root, f"evalburn_s{seed}"),
                            "MODEL.WEIGHTS", burnin_ckpt], eval_only=True))
    da = common + ["OUTPUT_DIR", aldi_out, "MODEL.WEIGHTS", burnin_ckpt,
                   "SOLVER.MAX_ITER", da_iters,
                   "SOLVER.STEPS", f"({da_iters - 1},)",
                   "SOLVER.CHECKPOINT_PERIOD", da_iters,
                   "DOMAIN_ADAPT.TEACHER.THRESHOLD", threshold]
    t0 = time.time()
    run_cli(ALDI_CFG, da)
    walls["aldi_train_s"] = time.time() - t0
    res["mean_pseudo_labels"] = mean_pseudo_labels(aldi_out)
    res["aldi"] = _ap50(run_cli(ALDI_CFG, da, eval_only=True, resume=True))
    return {
        "benchmark": "synthetic shift (fog+blur+color-cast), "
                     "aldi_tpu_torch/tools/efficacy.py make_shift_split",
        "protocol": f"burn-in {burnin} -> {{source-only +{da_iters} | "
                    f"ALDI++ {da_iters}}}; teacher threshold {threshold}; "
                    "teacher-EMA AP50",
        "seed": seed,
        "results": res,
        "wall_s": walls,
        "card": card_name(),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "output", "efficacy"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--burnin", type=int, default=1200)
    p.add_argument("--da-iters", type=int, default=1600)
    p.add_argument("--threshold", type=float, default=SEED0_THRESHOLD)
    p.add_argument("--device", default=None,
                   help="MODEL.DEVICE (cpu to check the plumbing)")
    args = p.parse_args()
    t0 = time.time()
    report = run(args.out, args.seed, args.burnin, args.da_iters,
                 args.threshold, args.device)
    report["wall_s"]["total_s"] = time.time() - t0
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "efficacy.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
