"""Host-side geometric transforms (the reference's "weak" augmentation).

Port of ``aldi_tpu/data/transforms.py:25-210`` (its PIL branch):
``ResizeShortestEdge`` with "choice" or "range" sampling, ``RandomFlip``
and the optional ``RandomCrop`` before the resize (reference
``aldi/aug.py:21-23``). Pixel-space strong augmentations run on the device
(``data/strong_aug.py``); only geometry happens on the host, so the gt
boxes and both views share one transform.

Output contract (the ragged -> static boundary): every record is resized,
flipped, then pasted top-left onto the fixed canvas; boxes are transformed
alongside; the actual (h, w) is reported so the model can clip and mask the
padding. Images are decoded and resized with PIL, exactly as the JAX
package's PIL branch does; the JAX package's native decoder
(``aldi_native``) is not used. Precomputed proposals
(``MODEL.LOAD_PROPOSALS``) are not ported: ROADMAP.md lists them.
"""

from typing import List, Tuple

import numpy as np
from PIL import Image


def resize_shortest_edge(
    img: Image.Image, short: int, max_size: int
) -> Tuple[Image.Image, float]:
    """Scale so the short edge == short, capped so long edge <= max_size.
    Returns (resized, scale)."""
    w, h = img.size
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nw, nh = int(w * scale + 0.5), int(h * scale + 0.5)
    return img.resize((nw, nh), Image.BILINEAR), scale


def _boxes_to_arrays(anns, scale, max_gt, do_flip, out_w, out_h):
    """XYWH annotations -> padded XYXY arrays in resized-image coords."""
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    for i, a in enumerate(anns[:max_gt]):
        x, y, bw, bh = a["bbox"]
        boxes[i] = [x * scale, y * scale, (x + bw) * scale, (y + bh) * scale]
        classes[i] = a["category_id"]
        valid[i] = True
    if do_flip:
        x0 = boxes[:, 0].copy()
        boxes[:, 0] = out_w - boxes[:, 2]
        boxes[:, 2] = out_w - x0
    np.clip(boxes[:, [0, 2]], 0, out_w, out=boxes[:, [0, 2]])
    np.clip(boxes[:, [1, 3]], 0, out_h, out=boxes[:, [1, 3]])
    keep = (boxes[:, 2] - boxes[:, 0] > 0.5) & (boxes[:, 3] - boxes[:, 1] > 0.5)
    valid &= keep
    return boxes, classes, valid


def _random_crop(img, anns, rng, crop_type: str, crop_size):
    """RandomCrop (inserted before the resize): relative_range, relative,
    absolute or absolute_range crops; boxes are shifted and clipped into
    the crop and empty ones dropped."""
    w, h = img.size
    if crop_type == "relative_range":
        rh = crop_size[0] + rng.random() * (1.0 - crop_size[0])
        rw = crop_size[1] + rng.random() * (1.0 - crop_size[1])
        ch, cw = int(h * rh + 0.5), int(w * rw + 0.5)
    elif crop_type == "relative":
        ch, cw = int(h * crop_size[0] + 0.5), int(w * crop_size[1] + 0.5)
    elif crop_type == "absolute":
        ch, cw = min(int(crop_size[0]), h), min(int(crop_size[1]), w)
    elif crop_type == "absolute_range":
        lo = min(int(crop_size[0]), h)
        hi = min(int(crop_size[1]), h)
        ch = int(rng.integers(lo, hi + 1))
        lo = min(int(crop_size[0]), w)
        hi = min(int(crop_size[1]), w)
        cw = int(rng.integers(lo, hi + 1))
    else:
        raise ValueError(f"unknown crop type {crop_type}")
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    img = img.crop((x0, y0, x0 + cw, y0 + ch))
    out = []
    for a in anns:
        bx, by, bw, bh = a["bbox"]
        nx0 = max(bx - x0, 0.0)
        ny0 = max(by - y0, 0.0)
        nx1 = min(bx + bw - x0, cw)
        ny1 = min(by + bh - y0, ch)
        if nx1 - nx0 > 1 and ny1 - ny0 > 1:
            out.append(dict(a, bbox=[nx0, ny0, nx1 - nx0, ny1 - ny0]))
    return img, out


def transform_record(
    record: dict,
    rng: np.random.Generator,
    min_sizes: List[int],
    max_size: int,
    canvas: Tuple[int, int],
    flip: bool = True,
    sampling: str = "choice",
    max_gt: int = 100,
    bgr: bool = True,
    crop: dict = None,
    is_train: bool = True,
):
    """record (COCO dict) -> dict of fixed-shape numpy arrays: {image uint8
    [H, W, 3] on the canvas, sizes [2], boxes [G, 4], classes [G],
    valid [G], image_id, scale}. ``rng`` is drawn from in the JAX
    package's order (short edge, flip, then the crop)."""
    anns_src = [
        a for a in record.get("annotations", [])
        if not a["iscrowd"] and not a.get("ignore", 0)
    ]
    do_crop = bool(is_train and crop and crop.get("enabled"))
    if is_train and sampling == "range" and len(min_sizes) == 2:
        short = int(rng.integers(min_sizes[0], min_sizes[1] + 1))
    elif is_train:
        short = int(min_sizes[rng.integers(len(min_sizes))])
    else:
        short = int(min_sizes[0])
    do_flip = bool(is_train and flip and rng.random() < 0.5)

    img = Image.open(record["file_name"])
    img = img.convert("RGB")
    if do_crop:
        img, anns_src = _random_crop(img, anns_src, rng, crop["type"],
                                     crop["size"])
    img, scale = resize_shortest_edge(img, short, max_size)
    w, h = img.size

    boxes, classes, valid = _boxes_to_arrays(
        anns_src, scale, max_gt, do_flip, w, h
    )
    arr = np.asarray(img, np.uint8)
    if do_flip:
        arr = arr[:, ::-1]
    if bgr:
        arr = arr[:, :, ::-1]

    ch, cw = canvas
    if h > ch or w > cw:  # safety: canvas should already cover max resize
        arr = arr[:ch, :cw]
        h, w = min(h, ch), min(w, cw)
        np.clip(boxes[:, [0, 2]], 0, w, out=boxes[:, [0, 2]])
        np.clip(boxes[:, [1, 3]], 0, h, out=boxes[:, [1, 3]])
    out_img = np.zeros((ch, cw, 3), np.uint8)
    out_img[:h, :w] = arr
    return {
        "image": out_img,
        "sizes": np.asarray([h, w], np.int32),
        "boxes": boxes,
        "classes": classes,
        "valid": valid,
        "image_id": record["image_id"],
        "scale": scale,
    }
