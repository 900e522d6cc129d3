"""Benchmark dataset registrations.

A copy of ``aldi_tpu/data/datasets.py``, registering into the port's own
catalog. The same 11 COCO-format datasets the reference registers
(``aldi/datasets.py:4-22``): Cityscapes / Foggy Cityscapes (CS -> FCS),
Sim10k -> Cityscapes-cars, and CFC Kenai -> Channel. Dataset root defaults
to ``./datasets`` and can be overridden with $DETECTRON2_DATASETS or
$ALDI_DATASETS (reference uses cwd-relative paths).
"""

import os

from .catalog import DatasetCatalog, register_coco_instances

_ROOT = os.environ.get(
    "ALDI_DATASETS", os.environ.get("DETECTRON2_DATASETS", "datasets")
)


def _reg(name, json_rel, image_rel):
    if name in DatasetCatalog:
        return
    register_coco_instances(
        name, {},
        os.path.join(_ROOT, json_rel),
        os.path.join(_ROOT, image_rel),
    )


def register_all():
    # Cityscapes -> Foggy Cityscapes
    _reg("cityscapes_train",
         "cityscapes/annotations/cityscapes_train_instances.json",
         "cityscapes/leftImg8bit/train")
    _reg("cityscapes_val",
         "cityscapes/annotations/cityscapes_val_instances.json",
         "cityscapes/leftImg8bit/val")
    _reg("cityscapes_foggy_train",
         "cityscapes/annotations/cityscapes_train_instances_foggyALL.json",
         "cityscapes/leftImg8bit_foggy/train")
    _reg("cityscapes_foggy_val",
         "cityscapes/annotations/cityscapes_val_instances_foggyALL.json",
         "cityscapes/leftImg8bit_foggy/val")
    # variant evaluated with COCO-pretrained class indices
    _reg("cityscapes_foggy_val_coco_ids",
         "cityscapes/annotations/cityscapes_val_instances_foggyALL_coco.json",
         "cityscapes/leftImg8bit_foggy/val")

    # Sim10k -> Cityscapes (cars only)
    _reg("sim10k_cars_train",
         "sim10k/coco_car_annotations.json",
         "sim10k/images")
    _reg("cityscapes_cars_train",
         "cityscapes/annotations/cityscapes_train_instances_cars.json",
         "cityscapes/leftImg8bit/train")
    _reg("cityscapes_cars_val",
         "cityscapes/annotations/cityscapes_val_instances_cars.json",
         "cityscapes/leftImg8bit/val")

    # CFC Kenai -> Channel. Reference layout is ``datasets/cfc_daod/...``
    # (``aldi/datasets.py:19-22``); a reference-prepared datasets dir drops
    # in unchanged. A legacy ``cfc/...`` tree is accepted as fallback.
    def _cfc_root():
        return (
            "cfc" if os.path.isdir(os.path.join(_ROOT, "cfc"))
            and not os.path.isdir(os.path.join(_ROOT, "cfc_daod"))
            else "cfc_daod"
        )

    c = _cfc_root()
    _reg("cfc_train", f"{c}/coco_labels/cfc_train.json",
         f"{c}/images/cfc_train")
    _reg("cfc_val", f"{c}/coco_labels/cfc_val.json", f"{c}/images/cfc_val")
    _reg("cfc_channel_train",
         f"{c}/coco_labels/cfc_channel_train.json",
         f"{c}/images/cfc_channel_train")
    _reg("cfc_channel_test",
         f"{c}/coco_labels/cfc_channel_test.json",
         f"{c}/images/cfc_channel_test")


register_all()
