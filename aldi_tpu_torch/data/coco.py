"""COCO-format JSON loading (pycocotools-free).

A copy of ``aldi_tpu/data/coco.py``. Returns detectron2's record schema:
file_name, image_id, height, width, and annotations with XYWH ``bbox``,
contiguous ``category_id``, ``iscrowd``.
"""

import json
import os
from typing import List

from .catalog import MetadataCatalog


def load_coco_json(json_file: str, image_root: str, dataset_name: str = None
                   ) -> List[dict]:
    with open(json_file, "r") as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    cat_ids = [c["id"] for c in cats]
    id_map = {cid: i for i, cid in enumerate(cat_ids)}
    if dataset_name is not None:
        md = MetadataCatalog.get(dataset_name)
        md.setdefault("thing_classes", [c["name"] for c in cats])
        md["thing_dataset_id_to_contiguous_id"] = id_map

    anns_by_image = {}
    for ann in coco.get("annotations", []):
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in coco["images"]:
        anns = []
        for ann in anns_by_image.get(img["id"], []):
            anns.append(
                {
                    "bbox": ann["bbox"],  # XYWH
                    "category_id": id_map[ann["category_id"]],
                    "iscrowd": ann.get("iscrowd", 0),
                    # kept (not dropped): evaluation treats these as ignore
                    # regions per the pycocotools protocol; training filters
                    # them out (transforms.py)
                    "ignore": ann.get("ignore", 0),
                    "area": ann.get(
                        "area", ann["bbox"][2] * ann["bbox"][3]
                    ),
                }
            )
        records.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "image_id": img["id"],
                "height": img["height"],
                "width": img["width"],
                "annotations": anns,
            }
        )
    return records


def filter_empty(records: List[dict]) -> List[dict]:
    """DATALOADER.FILTER_EMPTY_ANNOTATIONS: keep images with at least one
    non-crowd annotation."""
    return [
        r for r in records
        if any(not a["iscrowd"] for a in r["annotations"])
    ]
