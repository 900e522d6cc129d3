"""Detection evaluation: inference over a dataset, then COCO AP.

Port of ``inference_on_dataset`` (``aldi_tpu/engine/evaluator.py:84-161``),
single process: inference over a ``TestLoader`` on the detector's device,
canvas-space detections mapped back to original image coordinates on the
host (the reference's ``do_postprocess`` rescale), and the COCO bbox
protocol of ``engine/coco_eval.py``. Gathering predictions across
processes (``gather_predictions``, ``:26-82``) waits for the multi-GPU
item of ROADMAP.md.
"""

import time
from collections import defaultdict
from typing import Dict

import torch

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data.loader import TestLoader
from .coco_eval import evaluate_detections


def inference_on_dataset(
    detector, dataset_name: str, cfg, batch_size: int = 8, logger=None,
    module=None,
) -> Dict[str, float]:
    """AP of ``module`` (an RCNN: the EMA teacher, say; the detector's own
    by default) on a registered dataset. Returns the ``bbox/AP``,
    ``bbox/AP50``, ... keys of ``evaluate_detections`` and
    ``images_per_sec`` (host clock over the inference loop, loading
    included)."""
    loader = TestLoader(dataset_name, cfg, detector.canvas, batch_size)
    md = MetadataCatalog.get(dataset_name)

    predictions = defaultdict(list)
    n_images = 0
    t0 = time.time()
    for batch, metas in loader:
        images = torch.from_numpy(batch["image"]).to(detector.device)
        sizes = torch.from_numpy(batch["sizes"]).to(detector.device)
        out = detector.forward_inference(images, sizes, module=module)
        boxes, scores, classes, valid = (t.cpu().numpy() for t in out)
        for i, meta in enumerate(metas):
            s = meta["scale"]
            for b, sc, cl, v in zip(boxes[i], scores[i], classes[i], valid[i]):
                if not v:
                    continue
                x0, y0, x1, y1 = (b / s).tolist()
                predictions[meta["image_id"]].append(
                    {
                        "bbox": [x0, y0, x1 - x0, y1 - y0],  # XYWH
                        "score": float(sc),
                        "category_id": int(cl),
                    }
                )
            n_images += 1
    infer_time = time.time() - t0

    # ground truth in contiguous category ids
    records = DatasetCatalog.get(dataset_name)
    annotations = {
        r["image_id"]: [
            {
                "bbox": a["bbox"],
                "category_id": a["category_id"],
                "iscrowd": a["iscrowd"],
                "ignore": a.get("ignore", 0),
                "area": a["area"],
            }
            for a in r["annotations"]
        ]
        for r in records
    }
    n_classes = len(md.get("thing_classes", [])) or (
        max(
            (a["category_id"] for anns in annotations.values() for a in anns),
            default=0,
        )
        + 1
    )
    results = evaluate_detections(
        dict(predictions), annotations, list(range(n_classes))
    )
    results["images_per_sec"] = n_images / max(infer_time, 1e-9)
    if logger:
        logger.info(f"[{dataset_name}] {results}")
    return results
