#!/usr/bin/env python3
"""Calibrate DOMAIN_ADAPT.TEACHER.THRESHOLD against a burn-in teacher.

Port of ``tools/calibrate_threshold.py``: the teacher (the EMA when it is
on) runs over a dataset through the port's ``TestLoader`` and
``forward_inference``; the tool prints the detection scores' percentiles
and the pseudo-labels per image at candidate thresholds beside the gt
density, and recommends the density-matched threshold: the score quantile
at which the pseudo-labels per image equal the gt objects per image.

    python3 -m aldi_tpu_torch.tools.calibrate_threshold \\
        --config-file <burn-in config.yaml> [--dataset NAME] \\
        [--thresholds 0.3,0.4,...] [--out report.json] [--device cuda] \\
        MODEL.WEIGHTS <burn-in checkpoint> [KEY VALUE ...]

It runs on the CUDA card unless ``--device cpu`` is given. The datasets
must be registered in the port's catalog (``aldi_tpu_torch.data.catalog``).
"""

import argparse
import json
import sys

import numpy as np


def collect_scores(trainer, dataset_name, batch_size=8):
    """The teacher's (``trainer.eval_module()``) valid detection scores
    over a dataset, one array per image."""
    from ..data.loader import TestLoader
    from ..engine.evaluator import device_inputs

    detector = trainer.detector
    module = trainer.eval_module()
    loader = TestLoader(dataset_name, trainer.cfg, detector.canvas,
                        batch_size)
    per_image = []
    for batch, metas in loader:
        images, sizes, pre = device_inputs(batch, detector.device)
        _, scores, _, valid = (x.cpu().numpy() for x in
                               detector.forward_inference(
                                   images, sizes, module=module, **pre))
        for i in range(len(metas)):
            per_image.append(scores[i][valid[i].astype(bool)])
    return per_image


def gt_density(dataset_name):
    """Gt objects per image of a registered dataset."""
    from ..data.catalog import DatasetCatalog

    records = DatasetCatalog.get(dataset_name)
    n = sum(len(r["annotations"]) for r in records)
    return n / max(len(records), 1)


def _flat(rows):
    return (np.concatenate(rows) if rows and any(len(r) for r in rows)
            else np.zeros((0,), np.float32))


def recommend_threshold(rows, gt_per_image, floor=0.05):
    """The density-matched threshold: the score quantile at which the
    pseudo-labels per image equal ``gt_per_image``. None when the teacher
    has too few detections above ``floor`` to reach that density at any
    threshold."""
    flat = _flat(rows)
    target = gt_per_image * max(len(rows), 1)
    usable = np.sort(flat[flat > floor])[::-1]
    if usable.size >= target and target >= 1:
        return float(usable[int(round(target)) - 1])
    return None


def calibrate(trainer, dataset_name, thresholds):
    """The report of ``tools/calibrate_threshold.py`` ``calibrate``."""
    rows = collect_scores(trainer, dataset_name)
    flat = _flat(rows)
    out = {
        "dataset": dataset_name,
        "images": len(rows),
        "detections": int(flat.size),
        "gt_per_image": round(gt_density(dataset_name), 2),
        "score_percentiles": {
            f"p{p}": round(float(np.percentile(flat, p)), 4)
            for p in (10, 25, 50, 75, 90, 99)
        } if flat.size else {},
        "pseudo_per_image": {
            f"{t:.2f}": round(float(np.mean([(r > t).sum() for r in rows])), 2)
            for t in thresholds
        },
    }
    thr = recommend_threshold(rows, out["gt_per_image"])
    if thr is not None:
        out["recommended_threshold"] = round(thr, 4)
        out["density_at_recommended"] = round(
            float(np.mean([(r > thr).sum() for r in rows])), 2)
    else:
        out["recommended_threshold"] = None
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-file", required=True)
    p.add_argument("--dataset", default=None,
                   help="defaults to DATASETS.UNLABELED[0]")
    p.add_argument("--thresholds",
                   default="0.3,0.4,0.5,0.6,0.7,0.8,0.9")
    p.add_argument("--out", default=None, help="optional JSON output path")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    from ..config import get_cfg
    from ..engine.trainer import ALDITrainer

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    trainer = ALDITrainer(cfg, device=args.device)
    trainer.resume_or_load(resume=False)

    dataset = args.dataset or (cfg.DATASETS.UNLABELED or cfg.DATASETS.TEST)[0]
    thresholds = [float(t) for t in args.thresholds.split(",")]
    report = calibrate(trainer, dataset, thresholds)
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
