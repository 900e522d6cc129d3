"""A tiny copy of the benchmark for its CPU tests: a checkout root with its
own BENCHMARK.json whose cells are the real ones at a tiny size (ResNet-26,
a 128 x 256 canvas, 2 + 2 images), and a copy of ``benchmark/`` that holds
their workload and configuration files. The tiny port computes in float32,
so that it meets the float32 reference within ``TINY_LIMITS``: a run is
correct, and a fault or the float8 control stands out."""

import json
import shutil
from pathlib import Path

from .. import harness

TINY_R50 = {"MODEL.RESNETS.DEPTH": 26, "TPU.CANVAS": [128, 256],
            "TPU.MAX_GT": 8, "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200,
            "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100,
            "MODEL.RPN.PRE_NMS_TOPK_TEST": 100,
            "MODEL.RPN.POST_NMS_TOPK_TEST": 50,
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 64,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32,
            "TEST.DETECTIONS_PER_IMAGE": 20, "TPU.COMPUTE_DTYPE": "float32"}
TINY_TRAIN = {"n_labeled": 2, "n_unlabeled": 2, "pool": 3, "check_steps": 2,
              "traced_steps": 1, "gt_count": [1, 4], "gt_side": [8, 40],
              "cut": [16, 32]}
TINY_LIMITS = {"daod_step": {"change_gap_p90": 1e-3,
                             "teacher_change_gap_p90": 1e-3,
                             "teacher_score_gap": 1e-3,
                             "matched_score_gap": 1e-3,
                             "matched_box_gap": 1e-3},
               "serve": {"score_off_share": 0.0, "count_gap": 0.0,
                         "miss_share": 0.0, "duplicate_share": 0.0}}
TINY_SERVE = {"request_images": 2, "pool": 2, "warmup": 1,
              "check_requests": 2, "traced_requests": 2, "cut": [16, 32],
              "gt_count": [1, 4], "gt_side": [8, 40]}


def make(tmp, cells=("r50fpn.daod_step", "r50fpn.serve")):
    """(root, bench) of a tiny copy under ``tmp`` with ``cells``."""
    tmp = Path(tmp)
    root, bench = tmp / "checkout", tmp / "checkout" / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] in cells]
    for w in spec["workloads"]:
        path = bench / "workloads" / f"{w['name']}.json"
        work = json.loads(path.read_text())
        work.update(TINY_TRAIN if work["traffic"] == "daod_step"
                    else TINY_SERVE)
        work["limits"] = TINY_LIMITS[work["traffic"]]
        path.write_text(json.dumps(work))
    for c in spec["configs"]:
        path = bench / "configs" / f"{c['name']}.json"
        conf = json.loads(path.read_text())
        conf["yaml"] = str(harness.ROOT / conf["yaml"])
        conf["overrides"] = {**conf["overrides"], **TINY_R50}
        path.write_text(json.dumps(conf))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench
