"""The ALDI++ DAOD training step.

Port of ``aldi_tpu/engine/train_step.py:100-393`` for the R-CNN family, with
the same stream logic: the EMA update before the step; the teacher pass
(pseudo-labels and distill targets, no gradient); strong views of the
labeled and unlabeled batches derived on the device; the student's streams
(``labeled_weak``, ``labeled_strong`` and the distill stream on the
pseudo-labels), each weighted ``n_s / n_eff`` as the reference's gradient
accumulation weighs them; one ``backward()`` per stream
(``SOLVER.BACKWARD_AT_END: false``) or one for their sum (true); the
optimizer step.

The JAX step draws from ``jax.random``; here ``draw_step`` makes every draw
of a step up front from a ``torch.Generator`` (static shapes: the canvas's
N anchors, POST_NMS_TOPK_TRAIN + MAX_GT ROI candidates, the canvas's
pixels), and ``step(state, batch, draws)`` is then deterministic. The step
updates the state in place (the student's and the teacher's parameters, the
optimizer's buffers, the step count) and returns it with the metrics.

Batches: ``{"labeled": {"image" [B, H, W, 3] in 0..255, "sizes" [B, 2],
"boxes" [B, MAX_GT, 4], "classes" [B, MAX_GT], "valid" [B, MAX_GT]},
"unlabeled": {"image", "sizes"}}``, on the detector's device.
"""

import copy
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from ..config import resolve_canvas
from ..data.strong_aug import strong_aug_draws, strong_augment
from ..models.rcnn import check_trainable
from ..ops.matcher import sample_proposals_draws, subsample_indices_draws
from ..solver import build_lr_schedule, build_optimizer, clip_gradients, set_lr
from ..structures import Instances
from .distill import gate_hard_losses
from .ema import ema_update


@dataclass
class TrainState:
    step: int
    student: torch.nn.Module  # the detector's RCNN module
    teacher: Optional[torch.nn.Module]  # EMA copy; None without EMA
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]


def stream_flags(cfg) -> SimpleNamespace:
    """Which streams and teacher parts a config's step runs."""
    contents = cfg.DATASETS.BATCH_CONTENTS
    d = cfg.DOMAIN_ADAPT.DISTILL
    has_unlabeled = (any(s.startswith("unlabeled") for s in contents)
                     and len(cfg.DATASETS.UNLABELED) > 0)
    do_hard = any([d.HARD_ROIH_CLS_ENABLED, d.HARD_ROIH_REG_ENABLED,
                   d.HARD_OBJ_ENABLED, d.HARD_RPN_REG_ENABLED])
    do_soft = any([d.ROIH_CLS_ENABLED, d.ROIH_REG_ENABLED, d.OBJ_ENABLED,
                   d.RPN_REG_ENABLED])
    return SimpleNamespace(
        weak="labeled_weak" in contents,
        strong="labeled_strong" in contents,
        distill=has_unlabeled and (do_hard or do_soft),
        soft=do_soft,
        teacher_anchors=d.OBJ_ENABLED or d.RPN_REG_ENABLED,
        ema=cfg.EMA.ENABLED,
    )


def _share_buffers(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Make ``dst``'s buffers (FrozenBN statistics) the very tensors of
    ``src``, as the JAX state shares its ``frozen`` collection."""
    src_modules = dict(src.named_modules())
    for name, mod in dst.named_modules():
        for b in mod._buffers:
            mod._buffers[b] = src_modules[name]._buffers[b]


def create_train_state(cfg, detector, weights=None,
                       teacher_weights=None) -> TrainState:
    """The training state around ``detector.module`` (the student), after
    loading ``weights`` (a state dict) if given. With EMA the teacher is a
    copy (``teacher_weights`` if given, else the student's), without
    gradients, sharing the student's FrozenBN buffers."""
    student = detector.module
    if weights is not None:
        student.load_state_dict(weights)
    teacher = None
    if cfg.EMA.ENABLED:
        teacher = copy.deepcopy(student).requires_grad_(False)
        if teacher_weights is not None:
            teacher.load_state_dict(teacher_weights)
        _share_buffers(teacher, student)
    return TrainState(step=0, student=student, teacher=teacher,
                      optimizer=build_optimizer(cfg, student),
                      schedule=build_lr_schedule(cfg))


def draw_step(gen: torch.Generator, detector, n_labeled: int,
              n_unlabeled: int) -> dict:
    """Every random draw of one step, made from ``gen`` on its device and
    returned on the detector's: per student stream the anchor sampler's and
    the ROI sampler's draws, the teacher's anchor sampler's draws, and the
    strong augmentation's draws per batch."""
    cfg = detector.cfg
    s = stream_flags(cfg)
    n_anchors = detector.anchors_cat.shape[0]
    rpn = detector.rpn_params
    k_rpn = min(rpn["batch_size_per_image"], n_anchors)
    n_cand = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + (
        cfg.TPU.MAX_GT if cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT else 0)
    canvas = resolve_canvas(cfg)
    aug = cfg.AUG

    def anchors(b):
        return subsample_indices_draws(gen, (b,), n_anchors, k_rpn,
                                       rpn["positive_fraction"])

    def student(b):
        return {"rpn": anchors(b),
                "roi": sample_proposals_draws(gen, (b,), n_cand)}

    out = {}
    if s.weak:
        out["weak"] = student(n_labeled)
    if s.strong:
        out["strong"] = student(n_labeled)
        out["aug_labeled"] = strong_aug_draws(
            gen, n_labeled, canvas, aug.LABELED_INCLUDE_RANDOM_ERASING,
            aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
    if s.distill:
        if s.teacher_anchors:
            out["teacher"] = anchors(n_unlabeled)
        out["distill"] = student(n_unlabeled)
        out["aug_unlabeled"] = strong_aug_draws(
            gen, n_unlabeled, canvas, aug.UNLABELED_INCLUDE_RANDOM_ERASING,
            aug.UNLABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
    return to_device(out, detector.device)


def to_device(tree, device):
    """A nested dict of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def make_train_step(cfg, detector):
    """The step ``(state, batch, draws) -> (state, metrics)`` for this
    config's stream composition. Metrics carry the weighted losses under
    the JAX package's keys (``loss_*_source_strong``, ``loss_*_distill``,
    ...), ``total_loss`` and, with distillation, ``num_pseudo_labels``."""
    check_trainable(cfg)
    if int(cfg.TPU.GRAD_ACCUM) > 1:
        raise NotImplementedError(
            f"TPU.GRAD_ACCUM={cfg.TPU.GRAD_ACCUM} is not ported yet: "
            "ROADMAP.md lists it under slice 3")
    s = stream_flags(cfg)
    active = [n for n, on in (("weak", s.weak), ("strong", s.strong),
                              ("distill", s.distill)) if on]
    threshold = cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD
    max_gt = cfg.TPU.MAX_GT
    aug = cfg.AUG

    def train_step(state: TrainState, batch: dict, draws: dict, mark=None):
        """``mark``, if given, is called with a stage's name as each stage
        ends (for timing by stage)."""
        def done(stage):
            if mark is not None:
                mark(stage)

        metrics = {}
        if s.ema:
            ema_update(state.teacher, state.student, cfg.EMA.ALPHA,
                       state.step, cfg.EMA.START_ITER)
            done("ema update")
        teacher = state.teacher if s.ema else state.student
        student = state.student

        lab, uw = batch.get("labeled"), batch.get("unlabeled")
        n_ls = lab["image"].shape[0] if (s.weak or s.strong) else 0
        n_lw = n_ls if s.weak else 0
        n_uw = uw["image"].shape[0] if s.distill else 0
        n_eff = max(n_lw + (n_ls if s.strong else 0) + n_uw, 1)

        ctx = pseudo = None
        if s.distill:
            ctx, pseudo, t_metrics = detector.forward_teacher_ctx(
                teacher, uw["image"], uw["sizes"], draws.get("teacher"),
                threshold=threshold, max_gt=max_gt)
            metrics.update(t_metrics)
            done("teacher (pseudo-labels, distill targets)")
        with torch.no_grad():
            if s.strong:
                ls_images = strong_augment(
                    lab["image"], lab["sizes"], draws["aug_labeled"],
                    aug.LABELED_INCLUDE_RANDOM_ERASING, aug.LABELED_MIC_AUG,
                    aug.MIC_RATIO)
            if s.distill:
                us_images = strong_augment(
                    uw["image"], uw["sizes"], draws["aug_unlabeled"],
                    aug.UNLABELED_INCLUDE_RANDOM_ERASING,
                    aug.UNLABELED_MIC_AUG, aug.MIC_RATIO)
        done("strong views")
        gt = (Instances(lab["boxes"], lab["classes"], lab["valid"])
              if lab is not None else None)

        def weighted(losses, suffix, weight):
            return {f"{k}_{suffix}": v * weight for k, v in losses.items()}

        def stream(name):
            if name == "weak":
                losses, _ = detector.forward_train(
                    student, lab["image"], lab["sizes"], gt, draws["weak"])
                return weighted(losses, "source_weak", n_lw / n_eff)
            if name == "strong":
                losses, _ = detector.forward_train(
                    student, ls_images, lab["sizes"], gt, draws["strong"])
                return weighted(losses, "source_strong", n_ls / n_eff)
            std, s_aux = detector.forward_train(
                student, us_images, uw["sizes"], pseudo, draws["distill"])
            losses = gate_hard_losses(std, cfg)
            if s.soft:
                losses.update(detector.distill_losses(teacher, ctx, s_aux))
            return weighted(losses, "distill", n_uw / n_eff)

        def total_of(losses):
            return sum(v.to(torch.float32) for v in losses.values())

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_dict = {}
        if cfg.SOLVER.BACKWARD_AT_END or len(active) <= 1:
            for name in active:
                loss_dict.update(stream(name))
            total = total_of(loss_dict)
            total.backward()
            done("streams fwd + one bwd")
        else:  # one backward per stream: peak memory of one stream
            total = 0.0
            for name in active:
                losses = stream(name)
                t_s = total_of(losses)
                t_s.backward()
                total = total + t_s.detach()
                loss_dict.update(losses)
                done(f"{name} stream fwd+bwd")
        params = [p for g in opt.param_groups for p in g["params"]]
        clip_gradients(cfg, params)
        set_lr(opt, state.schedule(state.step))
        opt.step()
        state.step += 1
        done("optimizer")

        metrics.update({k: v.detach() for k, v in loss_dict.items()})
        metrics["total_loss"] = total.detach()
        return state, metrics

    return train_step
