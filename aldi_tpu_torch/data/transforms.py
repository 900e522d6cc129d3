"""Host-side geometric transforms (the reference's "weak" augmentation).

Port of ``aldi_tpu/data/transforms.py:25-210``:
``ResizeShortestEdge`` with "choice" or "range" sampling, ``RandomFlip``
and the optional ``RandomCrop`` before the resize (reference
``aldi/aug.py:21-23``). Pixel-space strong augmentations run on the device
(``data/strong_aug.py``); only geometry happens on the host, so the gt
boxes and both views share one transform.

Output contract (the ragged -> static boundary): every record is resized,
flipped, then pasted top-left onto the fixed canvas; boxes are transformed
alongside; the actual (h, w) is reported so the model can clip and mask the
padding. As in the JAX package, a choice without a crop is decoded,
resized, flipped and pasted by the native core (``data/native.py``) when
it builds with its codecs (libjpeg and libpng, which the JAX package's
extension links), and every other choice, and every choice where the core
does not build so, by PIL; each branch gives the JAX package's bits on the
same branch. A record's precomputed proposals
(``MODEL.LOAD_PROPOSALS``, ``data/proposals.py``) take the same drawn
choice as its image and gt boxes.
"""

from typing import List, Tuple

import numpy as np
from PIL import Image

from . import native as _native
from .proposals import transform_proposals


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


def _crop_box(w, h, rng, crop_type: str, crop_size):
    """RandomCrop's (x0, y0, cw, ch) in an image of w x h, drawn from
    ``rng``: relative_range, relative, absolute or absolute_range crops."""
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
    return x0, y0, cw, ch


def _crop(img, anns, box):
    """The crop ``box`` (inserted before the resize): boxes are shifted and
    clipped into the crop and empty ones dropped."""
    x0, y0, cw, ch = box
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


def draw_transform(record: dict, rng: np.random.Generator,
                   min_sizes: List[int], flip: bool = True,
                   sampling: str = "choice", crop: dict = None,
                   is_train: bool = True):
    """The random choices of ``transform_record`` for ``record``, drawn
    from ``rng`` in the JAX package's order (short edge, flip, then the
    crop): (short edge, flip, crop box or None). The crop's draws need the
    image's size, for which only the file's header is read: a rank of data
    parallelism draws every record of the global batch in order and
    decodes only its own."""
    if is_train and sampling == "range" and len(min_sizes) == 2:
        short = int(rng.integers(min_sizes[0], min_sizes[1] + 1))
    elif is_train:
        short = int(min_sizes[rng.integers(len(min_sizes))])
    else:
        short = int(min_sizes[0])
    do_flip = bool(is_train and flip and rng.random() < 0.5)
    box = None
    if is_train and crop and crop.get("enabled"):
        with Image.open(record["file_name"]) as im:
            w, h = im.size
        box = _crop_box(w, h, rng, crop["type"], crop["size"])
    return short, do_flip, box


def _pil_transform(record, anns_src, short, do_flip, box, max_size, canvas,
                   max_gt, bgr):
    """The PIL branch: crop, resize, flip, swap, paste."""
    img = Image.open(record["file_name"])
    img = img.convert("RGB")
    if box is not None:
        img, anns_src = _crop(img, anns_src, box)
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
    return out_img, h, w, scale, boxes, classes, valid


def apply_transform(record: dict, choice, max_size: int,
                    canvas: Tuple[int, int], max_gt: int = 100,
                    bgr: bool = True, proposal_topk: int = 0):
    """``record`` decoded and transformed by ``choice``
    (``draw_transform``'s): the output of ``transform_record``."""
    short, do_flip, box = choice
    anns_src = [
        a for a in record.get("annotations", [])
        if not a["iscrowd"] and not a.get("ignore", 0)
    ]
    ch, cw = canvas
    if _native is not None and box is None and _native.core() is not None:
        # the native core: decode, resize, flip, channel swap and paste
        # without the interpreter lock; its size is clamped to the canvas
        # before the resize
        out_img, h, w, scale = _native.load_resize_pad(
            record["file_name"], short, int(max_size), ch, cw, bgr, do_flip)
        boxes, classes, valid = _boxes_to_arrays(
            anns_src, scale, max_gt, do_flip, w, h)
    else:
        out_img, h, w, scale, boxes, classes, valid = _pil_transform(
            record, anns_src, short, do_flip, box, max_size, canvas, max_gt,
            bgr)
    out = {
        "image": out_img,
        "sizes": np.asarray([h, w], np.int32),
        "boxes": boxes,
        "classes": classes,
        "valid": valid,
        "image_id": record["image_id"],
        "scale": scale,
    }
    if proposal_topk > 0 and "proposal_boxes" in record:
        out["pboxes"], out["plogits"], out["pvalid"] = transform_proposals(
            record["proposal_boxes"], record["proposal_objectness_logits"],
            scale, do_flip, w, h, proposal_topk,
            crop_offset=None if box is None else box[:2],
            crop_wh=None if box is None else box[2:])
    return out


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
    proposal_topk: int = 0,
):
    """record (COCO dict) -> dict of fixed-shape numpy arrays: {image uint8
    [H, W, 3] on the canvas, sizes [2], boxes [G, 4], classes [G],
    valid [G], image_id, scale}; with ``proposal_topk > 0`` and a record
    that carries proposals, also {pboxes [K, 4], plogits [K], pvalid [K]}
    (``data/proposals.py`` ``transform_proposals``). ``rng`` is drawn from
    in the JAX package's order (short edge, flip, then the crop)."""
    choice = draw_transform(record, rng, min_sizes, flip, sampling, crop,
                            is_train)
    return apply_transform(record, choice, max_size, canvas, max_gt, bgr,
                           proposal_topk)
