"""Anchor sets and adversarial gt for the matcher tests: the CPU replay of
the culled kernels (``test_torch_port_match_cull.py``) and the kernels on
the card (``test_torch_port_cuda.py``). Plain numpy, no JAX.

Cases: random 16-200 px gt with 1, 100 or 256 slots (about 30% invalid);
gt edges and corners that exactly touch anchor edges, and gt equal to an
anchor; one box over the whole canvas; two identical boxes (a tie);
zero-width, zero-height and point boxes; boxes off the canvas; an invalid
first slot; an image without valid slots.
"""

import numpy as np

from aldi_tpu_torch.ops.anchors import AnchorGenerator

CANVAS = (256, 512)  # (h, w): 32,736 anchors over p2..p6
CASES = ("random_m1", "random_m100", "random_m256", "touching_edges",
         "covers_canvas", "identical_pair", "zero_area", "off_canvas",
         "first_slot_invalid", "image_without_valid")


def canvas_anchors(canvas=CANVAS):
    """The five-level anchors (p2..p6, sizes 32..512, three aspect
    ratios) of a canvas (h, w), float32 [N, 4]."""
    strides = [4, 8, 16, 32, 64]
    gen = AnchorGenerator([[32], [64], [128], [256], [512]],
                          [[0.5, 1.0, 2.0]], strides)
    hws = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in strides]
    return np.concatenate(gen(hws))


def _random_gt(rng, b, m, canvas=CANVAS):
    """16-200 px boxes inside the canvas, about 30% of the slots invalid."""
    wh = rng.uniform(16, 200, (b, m, 2))
    xy = rng.uniform(0, 1, (b, m, 2)) * (np.array(canvas[::-1]) - wh)
    valid = rng.uniform(0, 1, (b, m)) > 0.3
    valid[0, 0] = True
    return np.concatenate([xy, xy + wh], -1), valid


def match_case(name, anchors, b=3):
    """gt boxes [b, m, 4] float32 and valid flags [b, m] of case ``name``
    against ``anchors`` (numpy), from a seed."""
    anchors = np.asarray(anchors)
    rng = np.random.default_rng(CASES.index(name))
    m = {"random_m1": 1, "random_m256": 256}.get(name, 100)
    gt, valid = _random_gt(rng, b, m)
    if name == "touching_edges":  # boxes sharing an edge or a corner
        picks = rng.integers(0, len(anchors), (b, 40))
        a = anchors[picks]
        side = rng.uniform(8, 120, (b, 40, 2))
        right = np.stack([a[..., 2], a[..., 1], a[..., 2] + side[..., 0],
                          a[..., 3]], -1)
        below = np.stack([a[..., 0], a[..., 3], a[..., 2],
                          a[..., 3] + side[..., 1]], -1)
        corner = np.stack([a[..., 2], a[..., 3], a[..., 2] + side[..., 0],
                           a[..., 3] + side[..., 1]], -1)
        gt[:, :40] = np.where(rng.uniform(0, 1, (b, 40, 1)) < 0.5, right,
                              below)
        gt[:, 40:60] = corner[:, :20]
        gt[:, 60:70] = a[:, :10]  # the anchor itself: IoU 1
    elif name == "covers_canvas":
        gt[:, 7] = [-10.0, -10.0, CANVAS[1] + 10.0, CANVAS[0] + 10.0]
        valid[:, 7] = True
    elif name == "identical_pair":  # a tie: the first slot wins
        gt[:, 9] = gt[:, 4]
        valid[:, [4, 9]] = True
    elif name == "zero_area":
        gt[:, :30, 2] = gt[:, :30, 0]  # zero width
        gt[:, 30:50, 3] = gt[:, 30:50, 1]  # zero height
        gt[:, 50:60, 2:] = gt[:, 50:60, :2]  # a point
    elif name == "off_canvas":
        gt[:, :50] += np.array([-800.0, -600.0, -800.0, -600.0])
        gt[:, 50:80] += np.array([CANVAS[1] + 600.0, 0.0,
                                  CANVAS[1] + 600.0, 0.0])
    elif name == "first_slot_invalid":
        valid[:, 0] = False
    elif name == "image_without_valid":
        valid[1] = False
    return gt.astype(np.float32), valid
