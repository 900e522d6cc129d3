"""Optimizer and learning-rate schedules.

Port of the SGD half of ``aldi_tpu/solver.py`` (ADAMW waits for the ViTDet
slice). The JAX package's optimizer is
``masked(chain(clip?, add_decayed_weights(wd), sgd(lr, momentum,
nesterov)))``: ``torch.optim.SGD`` with ``weight_decay`` and ``momentum``
makes the same update (decay added to the gradient, then the momentum
trace, then -lr times it), and its first momentum buffer equals optax's
trace from zeros. The mask is the set of parameters with
``requires_grad`` (``ResNet(freeze_at=...)`` clears it on the frozen
stages). ``set_lr`` takes the schedule at the step count before the
update, as optax's ``scale_by_schedule`` does.
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


def build_optimizer(cfg, module: torch.nn.Module):
    """cfg + model -> ``torch.optim.SGD`` over the trainable parameters
    (``requires_grad``), with the learning rate of step 0."""
    name = (cfg.SOLVER.OPTIMIZER or "SGD").upper()
    if name == "ADAMW":
        raise NotImplementedError(
            "SOLVER.OPTIMIZER=ADAMW is not ported yet: ROADMAP.md, ViTDet "
            "slice")
    if name != "SGD":
        raise ValueError(f"Unsupported optimizer {name}")
    params = [p for p in module.parameters() if p.requires_grad]
    return torch.optim.SGD(
        params, lr=build_lr_schedule(cfg)(0), momentum=cfg.SOLVER.MOMENTUM,
        weight_decay=cfg.SOLVER.WEIGHT_DECAY, nesterov=cfg.SOLVER.NESTEROV)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


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
