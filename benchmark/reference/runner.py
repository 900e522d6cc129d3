"""The reference's entry points: a config as the benchmark states it, the
first steps of the ALDI++ DAOD step and a serving request, from weights,
batches and draws that the caller makes."""

import contextlib

import torch

from . import precision
from .config import get_cfg
from .engine.train_step import create_train_state, make_train_step
from .models.rcnn import RCNNDetector


def set_key(cfg, key, value):
    """Set ``key`` ("A.B.C") of a config node. The benchmark's harness sets
    the port's configuration with this too: the reference keeps the one
    copy, since it may import nothing of the harness's program side."""
    node = cfg
    *parents, leaf = key.split(".")
    for name in parents:
        node = node[name]
    node[leaf] = type(node[leaf])(value) if isinstance(
        node[leaf], (tuple, list)) else value


def config(yaml_path, overrides):
    """The configuration of ``yaml_path`` with ``overrides`` ({"A.B":
    value}), computed in float32."""
    cfg = get_cfg()
    cfg.merge_from_file(yaml_path)
    for key, value in overrides.items():
        set_key(cfg, key, value)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def detector(cfg, device):
    """The reference detector on ``device``; its weights are the caller's
    to load."""
    precision.strict_float32()
    det = RCNNDetector(cfg, device=device)
    vit = getattr(det.module.backbone, "net", None)
    if vit is not None:
        # the trunk is checkpointed image by image instead (models/rcnn.py)
        vit.use_act_checkpoint = False
    return det


def norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


@contextlib.contextmanager
def recording_teacher(det, into: list):
    """While open, every teacher pass of ``det`` (its ``forward_teacher``,
    which the step's ``forward_teacher_ctx`` calls) appends its detections
    to ``into`` as (boxes, scores, classes, valid), on the CPU. ``det`` may
    be the reference's detector or the program's: only what it returns is
    read."""
    own = det.forward_teacher

    def forward_teacher(*args, **kwargs):
        out = own(*args, **kwargs)
        boxes, scores, classes, valid = out[3]
        into.append((boxes.detach().float().cpu(),
                     scores.detach().float().cpu(), classes.cpu(),
                     valid.cpu()))
        return out

    det.forward_teacher = forward_teacher
    try:
        yield into
    finally:
        del det.forward_teacher


def train_steps(cfg, det, weights, steps, products="float32"):
    """Run the DAOD step on ``steps`` [(batch, draws), ...] from
    ``weights`` (a state dict). Returns each step's total loss, the norm
    of each trainable leaf's gradient of the first step as the optimizer
    took it, the norm of each leaf's change over all the steps in the
    student and in the EMA teacher, and under ``teacher`` each teacher
    pass's detections (boxes, scores, classes, valid)."""
    state = create_train_state(cfg, det, weights)
    step = make_train_step(cfg, det)
    trainable = {n: p for n, p in state.student.named_parameters()
                 if p.requires_grad}
    start = {n: p.detach().clone() for n, p in trainable.items()}
    losses, grads, seen = [], None, []
    with precision.products(products), recording_teacher(det, seen):
        for batch, draws in steps:
            state, metrics = step(state, batch, draws)
            losses.append(float(metrics["total_loss"]))
            if grads is None:
                grads = norms({n: p.grad for n, p in trainable.items()})
    change = norms({n: p.detach() - start[n] for n, p in trainable.items()})
    teacher = dict(state.teacher.named_parameters())
    teacher_change = norms({n: teacher[n].detach() - start[n]
                            for n in trainable})
    return {"loss": losses, "grad": grads, "change": change,
            "teacher_change": teacher_change, "teacher": seen}


def source_box(box, deltas, weights):
    """The box that ``deltas`` (of one class, [..., 4]) carry onto ``box``:
    the inverse of ``decode_deltas``."""
    wx, wy, ww, wh = weights
    w = (box[..., 2] - box[..., 0]) / torch.exp(deltas[..., 2] / ww)
    h = (box[..., 3] - box[..., 1]) / torch.exp(deltas[..., 3] / wh)
    cx = (box[..., 0] + box[..., 2]) / 2 - deltas[..., 0] / wx * w
    cy = (box[..., 1] + box[..., 3]) / 2 - deltas[..., 1] / wy * h
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@torch.no_grad()
def rescore(det, weights, images, sizes, boxes, classes, valid,
            products="float32", rounds=3):
    """The reference's score of each served detection (boxes [B, D, 4],
    classes [B, D], valid [B, D]) on the same images: its class's softmax
    probability from the box head at the proposal that the box head's own
    regression for that class carries onto the served box. That proposal
    is found by ``rounds`` fixed-point steps from the served box (the
    regression moves a box by a few percent, so each step shrinks the
    error by as much). Returns the scores and each proposal's
    ``level_margin``."""
    det.module.load_state_dict(weights)
    n_cls = det.num_classes
    idx = classes.long().clamp(0, n_cls - 1)[..., None, None].expand(
        classes.shape + (1, 4))
    boxes = boxes.float()
    with precision.products(products):
        feats = det.backbone(det.preprocess(images))
        src = boxes
        for _ in range(rounds):
            _, deltas, _ = det.box_head(feats, src, valid)
            d = torch.gather(deltas.float().reshape(
                deltas.shape[:-1] + (n_cls, 4)), -2, idx)[..., 0, :]
            src = source_box(boxes, d, det.box_reg_weights)
        cls, _, _ = det.box_head(feats, src, valid)
    probs = torch.softmax(cls.float(), dim=-1)
    return (torch.gather(probs, -1, classes.long()[..., None])[..., 0],
            level_margin(src))


def level_margin(boxes, min_level=2, max_level=5, canonical_size=224.0,
                 canonical_level=4):
    """How far each box [..., 4] lies from a boundary between two pyramid
    levels of ``assign_levels`` (log2 units of its side): a box on a
    boundary is pooled from either level as rounding falls."""
    area = ((boxes[..., 2] - boxes[..., 0])
            * (boxes[..., 3] - boxes[..., 1])).clamp(min=1e-12)
    x = canonical_level + torch.log2(torch.sqrt(area) / canonical_size)
    inner = torch.arange(min_level + 1, max_level + 1, device=boxes.device,
                         dtype=x.dtype)
    return (x[..., None] - inner).abs().amin(-1)


@torch.no_grad()
def detect(det, weights, images, sizes, products="float32"):
    """Detections (boxes [B, D, 4], scores, classes, valid) of a request,
    and under ``candidates`` the (box, class) pairs that entered its NMS
    (boxes [B, C, 4], scores, classes, valid)."""
    det.module.load_state_dict(weights)
    names = ("boxes", "scores", "classes", "valid")
    cands = []
    with precision.products(products):
        out = det.detect(images, sizes, candidates=cands)
    return {**dict(zip(names, out)), "candidates": dict(zip(names, cands[0]))}
