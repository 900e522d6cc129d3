"""Optimizer and learning-rate schedules.

Port of ``aldi_tpu/solver.py`` for SGD and ADAMW.

- SGD: the JAX package's ``masked(chain(clip?, add_decayed_weights(wd),
  sgd(lr, momentum, nesterov)))``. ``torch.optim.SGD`` with
  ``weight_decay`` and ``momentum`` makes the same update (decay added to
  the gradient, then the momentum trace, then -lr times it), and its first
  momentum buffer equals optax's trace from zeros.
- ADAMW (``:156-183``): ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8,
  weight_decay, mask=not pos_embed)``, for ViTDet-B followed by the layer
  decay ``0.7^(13 - layer_id)`` (patch and position embeddings layer 0,
  block i layer i + 1, everything outside the trunk multiplier 1,
  ``:43-61``). optax's update is ``-lr * mult * (adam + wd * p)``;
  ``torch.optim.AdamW`` with one parameter group per (multiplier, decay)
  pair, ``lr = schedule * mult`` and ``weight_decay`` wd or 0, makes the
  same one (``p * (1 - lr wd)``, then ``-lr * adam``). Deformable DETR's
  multipliers (``:184-202``): SOLVER.BACKBONE_LR_MULTIPLIER for the R50
  (the JAX module's ``backbone``, the port's ``backbone.0``), else
  SOLVER.LR_LINEAR_PROJ_MULTIPLIER for a parameter whose path holds a name
  of SOLVER.LR_LINEAR_PROJ_NAMES (``reference_points``,
  ``sampling_offsets``), else 1.

The mask is the set of parameters with ``requires_grad``
(``ResNet(freeze_at=...)`` clears it on the frozen stages). ``set_lr``
takes the schedule at the step count before the update, as optax's
``scale_by_schedule`` does, and keeps each group's multiplier.
"""

import math
from typing import Callable

import torch


def _warmup(cfg, count: float) -> float:
    iters = cfg.SOLVER.WARMUP_ITERS
    if count >= iters:
        return 1.0
    f = cfg.SOLVER.WARMUP_FACTOR
    return f * (1 - count / max(iters, 1)) + count / max(iters, 1)


def warmup_multistep_schedule(cfg) -> Callable[[int], float]:
    """D2 WarmupMultiStepLR: linear warmup from WARMUP_FACTOR, then
    BASE_LR * GAMMA^(milestones passed)."""
    base, gamma = cfg.SOLVER.BASE_LR, cfg.SOLVER.GAMMA
    steps = sorted(cfg.SOLVER.STEPS)

    def schedule(count):
        decay = gamma ** sum(count >= s for s in steps)
        return base * _warmup(cfg, count) * decay

    return schedule


def warmup_cosine_schedule(cfg) -> Callable[[int], float]:
    base, end = cfg.SOLVER.BASE_LR, cfg.SOLVER.BASE_LR_END
    max_iter = cfg.SOLVER.MAX_ITER

    def schedule(count):
        t = min(max(count / max_iter, 0.0), 1.0)
        cos = end + (1.0 - end) * 0.5 * (1 + math.cos(math.pi * t))
        return base * _warmup(cfg, count) * cos

    return schedule


def build_lr_schedule(cfg) -> Callable[[int], float]:
    name = cfg.SOLVER.LR_SCHEDULER_NAME
    if name in ("WarmupMultiStepLR", "WarmupMultiStepParamScheduler"):
        return warmup_multistep_schedule(cfg)
    if name == "WarmupCosineLR":
        return warmup_cosine_schedule(cfg)
    raise ValueError(f"Unknown LR scheduler {name}")


def vit_lr_decay_multiplier(name: str, num_layers: int = 12,
                            rate: float = 0.7) -> float:
    """``_vit_lr_decay_multipliers`` for one parameter of the port:
    rate^(num_layers + 1 - layer_id) inside the ViT trunk
    (``backbone.net.*``: embeddings layer 0, ``blocks.{i}`` layer i + 1),
    1.0 elsewhere (the feature pyramid included, as in the JAX package)."""
    if not name.startswith("backbone.net."):
        return 1.0
    parts = name.split(".")
    layer_id = int(parts[3]) + 1 if parts[2] == "blocks" else 0
    return rate ** (num_layers + 1 - layer_id)


def detr_lr_multiplier(name: str, backbone_mult: float, proj_mult: float,
                       proj_names) -> float:
    """Deformable DETR's multiplier for one parameter of the port: the R50
    (``backbone.0.*``) first, then any dotted component of the name in
    ``proj_names``."""
    if name.startswith("backbone.0."):
        return backbone_mult
    if any(part in proj_names for part in name.split(".")):
        return proj_mult
    return 1.0


def build_optimizer(cfg, module: torch.nn.Module):
    """cfg + model -> ``torch.optim.SGD`` or ``AdamW`` over the trainable
    parameters (``requires_grad``), with the learning rate of step 0. Each
    parameter group carries its learning-rate multiplier as ``lr_mult``."""
    name = (cfg.SOLVER.OPTIMIZER or "SGD").upper()
    lr0 = build_lr_schedule(cfg)(0)
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    if name == "SGD":
        return torch.optim.SGD(
            [{"params": [p for _, p in named], "lr_mult": 1.0}], lr=lr0,
            momentum=cfg.SOLVER.MOMENTUM, weight_decay=cfg.SOLVER.WEIGHT_DECAY,
            nesterov=cfg.SOLVER.NESTEROV)
    if name != "ADAMW":
        raise ValueError(f"Unsupported optimizer {name}")
    if cfg.MODEL.META_ARCHITECTURE == "DeformableDETR":
        def multiplier(n):
            return detr_lr_multiplier(
                n, cfg.SOLVER.BACKBONE_LR_MULTIPLIER,
                cfg.SOLVER.LR_LINEAR_PROJ_MULTIPLIER,
                cfg.SOLVER.LR_LINEAR_PROJ_NAMES)
    elif cfg.MODEL.BACKBONE.NAME == "build_vitdet_b_backbone":
        multiplier = vit_lr_decay_multiplier
    else:
        def multiplier(n):
            return 1.0
    wd = cfg.SOLVER.WEIGHT_DECAY
    groups = {}
    for n, p in named:
        mult = multiplier(n)
        key = (mult, 0.0 if n.split(".")[-1] == "pos_embed" else wd)
        groups.setdefault(key, []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "lr": lr0 * mult, "lr_mult": mult,
          "weight_decay": w} for (mult, w), ps in groups.items()],
        lr=lr0, betas=(0.9, 0.999), eps=1e-8)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The schedule's learning rate times each group's ``lr_mult``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: when the global norm of the
    gradients reaches ``max_norm``, each becomes ``g / norm * max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Returns the
    norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g.to(torch.float32) ** 2).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


@torch.no_grad()
def clip_gradients(cfg, params) -> None:
    """SOLVER.CLIP_GRADIENTS: by global norm or elementwise by value."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return
    if c.CLIP_TYPE == "value":
        for p in params:
            if p.grad is not None:
                p.grad.clamp_(-c.CLIP_VALUE, c.CLIP_VALUE)
    else:
        clip_by_global_norm(params, c.CLIP_VALUE)
