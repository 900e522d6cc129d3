"""Detection evaluation: inference over a dataset, then COCO AP.

Port of ``inference_on_dataset`` (``aldi_tpu/engine/evaluator.py:84-161``):
inference over a ``TestLoader`` on the detector's device, canvas-space
detections mapped back to original image coordinates on the host (the
reference's ``do_postprocess`` rescale), and the COCO bbox protocol of
``engine/coco_eval.py``. Under data parallelism each rank scores a strided
slice of the test set and the predictions are gathered to every rank
(``gather_predictions``, ``:26-82``: fixed-width rows, the image id split
in two float32 columns, padded to the largest count, then
``all_gather``), so every rank computes the same AP. On the data x model
grid the slices are the data ranks' (``mesh.data_rank``): every model rank
runs the inference of its data rank's slice (a tensor-parallel forward
needs its whole model group), and the gather keeps the rows of model
index 0.
"""

import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..data.catalog import DatasetCatalog, MetadataCatalog
from ..data import native
from ..data.loader import TestLoader
from ..parallel import mesh
from .coco_eval import evaluate_detections

PACK_WIDTH = 8


def pack_predictions(predictions: Dict[int, list]) -> np.ndarray:
    """Flatten per-image prediction dicts into fixed-width [N, 8] rows
    (image_id hi | image_id lo | bbox xywh | score | category). The id is
    split into two float32 columns (quotient and remainder by 2^20, each
    exact in float32): one float32 holds integers exactly only up to 2^24,
    so large COCO-style ids would collide after the gather."""
    rows = [
        [float(int(img_id) // (1 << 20)), float(int(img_id) % (1 << 20)),
         *d["bbox"], d["score"], float(d["category_id"])]
        for img_id, dets in predictions.items()
        for d in dets
    ]
    return np.asarray(rows, np.float32).reshape(-1, PACK_WIDTH)


def unpack_predictions(gathered: np.ndarray,
                       counts: np.ndarray) -> Dict[int, list]:
    """Inverse of ``pack_predictions`` over a gathered [P, cap, 8] array
    with ragged per-rank row counts [P]; padding rows beyond each count are
    ignored."""
    out = defaultdict(list)
    for p in range(gathered.shape[0]):
        for row in gathered[p, : int(counts[p])]:
            img_id = int(row[0]) * (1 << 20) + int(row[1])
            out[img_id].append(
                {
                    "bbox": [float(x) for x in row[2:6]],
                    "score": float(row[6]),
                    "category_id": int(row[7]),
                }
            )
    return dict(out)


def gather_predictions(predictions: Dict[int, list]) -> Dict[int, list]:
    """All-gather per-image predictions across the ranks so that every
    rank scores the full test set (reference ``COCOEvaluator(distributed=
    True)``, ``aldi/helpers.py:77``): packed rows padded to the largest
    count, on the group's device; of each model group the rows of its
    model index 0. At world 1 the predictions as they are."""
    if mesh.world() == 1:
        return predictions
    dev = mesh.comm_device()
    local = torch.from_numpy(pack_predictions(predictions)).to(dev)
    n = torch.tensor([local.shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.zeros_like(n) for _ in range(mesh.world())]
    dist.all_gather(counts, n)
    counts = torch.cat(counts).cpu().numpy()
    cap = max(int(counts.max()), 1)
    padded = torch.zeros((cap, PACK_WIDTH), dtype=torch.float32, device=dev)
    padded[: local.shape[0]] = local
    gathered = [torch.zeros_like(padded) for _ in range(mesh.world())]
    dist.all_gather(gathered, padded)
    keep = slice(None, None, mesh.model_world())  # model index 0's ranks
    return unpack_predictions(torch.stack(gathered[keep]).cpu().numpy(),
                              counts[keep])


def device_inputs(batch, device):
    """A ``TestLoader`` batch on ``device``: (images, sizes, the keywords
    of ``forward_inference``: under MODEL.LOAD_PROPOSALS the batch's
    proposals as ``precomputed``)."""
    def t(key):
        return torch.from_numpy(batch[key]).to(device)

    pre = ({"precomputed": {"boxes": t("pboxes"), "valid": t("pvalid")}}
           if "pboxes" in batch else {})
    return t("image"), t("sizes"), pre


def inference_on_dataset(
    detector, dataset_name: str, cfg, batch_size: int = 8, logger=None,
    module=None,
) -> Dict[str, float]:
    """AP of ``module`` (an RCNN or a YOLOv5, which runs in eval mode on
    its running statistics: the EMA teacher, say; the detector's own by
    default) on a registered dataset; under MODEL.LOAD_PROPOSALS the box
    head scores the test set's file proposals. Returns the ``bbox/AP``,
    ``bbox/AP50``, ... keys of ``evaluate_detections`` and
    ``images_per_sec`` (host clock over the inference loop, loading
    included; the whole test set's images under data parallelism, where
    each data rank scores its strided slice)."""
    loader = TestLoader(dataset_name, cfg, detector.canvas, batch_size,
                        shard=(mesh.data_rank(), mesh.data_world()))
    md = MetadataCatalog.get(dataset_name)
    if logger:
        logger.info(f"[{dataset_name}] host decoder: %s (%s)"
                    % native.decoder())

    predictions = defaultdict(list)
    n_images = 0
    t0 = time.time()
    for batch, metas in loader:
        images, sizes, pre = device_inputs(batch, detector.device)
        out = detector.forward_inference(images, sizes, module=module, **pre)
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
    predictions = gather_predictions(dict(predictions))
    infer_time = time.time() - t0

    # ground truth in contiguous category ids
    records = DatasetCatalog.get(dataset_name)
    if mesh.world() > 1:
        n_images = len(records)
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
