"""The ALDI++ DAOD training step.

Port of ``aldi_tpu/engine/train_step.py:100-393`` for the R-CNN family
(ResNet-FPN, ConvNeXt-FPN and ViTDet backbones), YOLOv5 and Deformable
DETR, with the same stream logic: the EMA update before the step; the
teacher pass (pseudo-labels and distill targets, no gradient); strong
views of the labeled and unlabeled batches derived on the device; the
student's streams (``labeled_weak``, ``labeled_strong``, with
DOMAIN_ADAPT.ALIGN the target_weak stream of alignment losses on the
unlabeled weak images, and the distill stream on the pseudo-labels: its
standard losses gated by the HARD_* flags, or, for a detector whose
``gate_hard`` is False (DETR's HardDistiller), passed through as they
are, ``:264-269``), each weighted ``n_s / n_eff`` as
the reference's gradient accumulation weighs them (``n_eff`` counts the
unlabeled batch once); one ``backward()`` per stream
(``SOLVER.BACKWARD_AT_END: false``) or one for their sum (true); the
optimizer step. YOLO's BatchNorm running statistics are the student's
buffers: each stream's training-mode forward moves them, in the JAX
step's order (per chunk: weak, strong, target_weak, distill; ``absorb``,
``:213-217``), and the EMA blends them into the teacher's own. With
``TPU.GRAD_ACCUM = k`` (``:334-378``) each stream
splits into k equal chunks after the teacher pass and the strong views
(computed once for the whole batch, as ``micro_full`` is): each chunk runs
forward and backward on the same parameters with its own draws, its
gradients are summed into ``.grad`` scaled by 1/k, the losses are averaged
over the chunks, and the optimizer steps once.

Under data parallelism (``parallel/mesh.py``) the batch and the draws are
a rank's share of the global batch's (``shard_draws``), every loss is
the rank's share of the global batch's loss (global denominators), and
the gradients are summed across the ranks once, after the last backward
and before clipping and the optimizer (``all_reduce_grads``): XLA's
inserted all-reduce in the JAX package's sharded step. The metrics are
the rank's shares; their sum over the ranks is the global batch's. On a
data x model grid the same holds over the data group; the model group's
collectives run inside the forward and backward (``parallel/tensor.py``),
an FSDP shard's gradient is summed as its backward makes it
(``parallel/fsdp.py``) and ``all_reduce_grads`` sums the others; the
clip's norm is world 1's (``solver.py``). A model group's ranks hold the
same batch, draws and metrics.

The JAX step draws from ``jax.random``; here ``draw_step`` makes every draw
of a step up front from a ``torch.Generator`` (static shapes: the canvas's
N anchors, POST_NMS_TOPK_TRAIN + MAX_GT ROI candidates, the canvas's
pixels), and ``step(state, batch, draws)`` is then deterministic. The step
updates the state in place (the student's and the teacher's parameters, the
optimizer's buffers, the step count) and returns it with the metrics. A
trainable parameter that no loss reached gets a zero gradient, as JAX's
gradient of it is zero: weight decay and momentum still move it.

MODEL.LOAD_PROPOSALS (Fast R-CNN, supervised only, as in the JAX package,
``:117-125,219-228``): the labeled batch's ``pboxes``/``pvalid`` go to the
labeled streams as their proposals, the RPN does not run, and the ROI
sampler draws over PRECOMPUTED_PROPOSAL_TOPK_TRAIN + MAX_GT candidates.

Batches: ``{"labeled": {"image" [B, H, W, 3] in 0..255, "sizes" [B, 2],
"boxes" [B, MAX_GT, 4], "classes" [B, MAX_GT], "valid" [B, MAX_GT]
(under MODEL.LOAD_PROPOSALS also "pboxes" [B, K, 4], "pvalid" [B, K])},
"unlabeled": {"image", "sizes"}}``, on the detector's device.
"""

import copy
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from ..config import resolve_canvas
from ..data.strong_aug import strong_aug_draws, strong_augment
from ..models.resnet import FrozenBN
from ..ops.matcher import (sample_proposals_draws, subsample_indices_draws,
                           subsample_labels_draws)
from ..parallel import fsdp, mesh, tensor
from ..parallel.mesh import all_reduce_grads
from ..solver import build_lr_schedule, build_optimizer, clip_gradients, set_lr
from ..structures import Instances
from ..utils.tracing import span
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
        align=cfg.DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED
        or cfg.DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED,
        soft=do_soft,
        teacher_anchors=d.OBJ_ENABLED or d.RPN_REG_ENABLED,
        ema=cfg.EMA.ENABLED,
    )


def _share_frozen_buffers(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Make the FrozenBN statistics of ``dst`` the very tensors of ``src``,
    as the JAX state shares its ``frozen`` collection. Other buffers (YOLO's
    BatchNorm running statistics, the JAX package's ``model_state``) stay
    the teacher's own."""
    src_modules = dict(src.named_modules())
    for name, mod in dst.named_modules():
        if isinstance(mod, FrozenBN):
            for b in mod._buffers:
                mod._buffers[b] = src_modules[name]._buffers[b]


def shard_for_grid(cfg, module: torch.nn.Module) -> None:
    """Split ``module`` for the process's grid (``parallel/mesh.py``):
    over the model group (``parallel/tensor.py``) at M > 1, then, with
    TPU.FSDP, over the data group (``parallel/fsdp.py``) at D > 1. Without
    a grid, or on a module already split, nothing changes."""
    if mesh.model_world() > 1:
        tensor.shard_module(module, mesh.model_world())
    if cfg.TPU.FSDP and mesh.data_world() > 1:
        fsdp.shard_module(module, mesh.data_world())


def create_train_state(cfg, detector, weights=None,
                       teacher_weights=None) -> TrainState:
    """The training state around ``detector.module`` (the student), after
    loading ``weights`` (world 1's state dict) if given. With EMA the
    teacher is a copy (``teacher_weights`` if given, else the student's),
    without gradients, sharing the student's FrozenBN buffers and keeping
    its own copy of every other buffer. On the grid both hold this rank's
    parts (``shard_for_grid``), the optimizer steps on them."""
    student = detector.module
    if weights is not None:
        student.load_state_dict(mesh.local_state_dict(student, weights))
    teacher = None
    if cfg.EMA.ENABLED:
        teacher = copy.deepcopy(student).requires_grad_(False)
        mesh.copy_shards(teacher, student)
        if teacher_weights is not None:
            teacher.load_state_dict(
                mesh.local_state_dict(teacher, teacher_weights))
        _share_frozen_buffers(teacher, student)
    for module in (student, teacher):
        if module is not None:
            shard_for_grid(cfg, module)
    return TrainState(step=0, student=student, teacher=teacher,
                      optimizer=build_optimizer(cfg, student),
                      schedule=build_lr_schedule(cfg))


def grad_accum(cfg) -> int:
    """TPU.GRAD_ACCUM: the number of chunks each stream splits into."""
    return max(int(cfg.TPU.GRAD_ACCUM), 1)


def draw_step(gen: torch.Generator, detector, n_labeled: int,
              n_unlabeled: int) -> dict:
    """Every random draw of one step, made from ``gen`` on its device and
    returned on the detector's: per student stream the anchor sampler's and
    the ROI sampler's draws (and, for a trunk with drop path, a ViT or a
    ConvNeXt, its keep masks), the teacher's anchor sampler's draws, and
    the strong augmentation's draws per batch. The target_weak stream of
    alignment (``"align"``) has no RPN loss: it takes the drop-path masks
    and, with instance alignment, the ROI sampler's draws over the
    proposals and one empty gt slot. With ``TPU.GRAD_ACCUM = k > 1`` each
    student stream's entry is a list of k chunks' draws. YOLO has no
    sampler and no drop path: its step draws only the strong views.
    Deformable DETR samples nothing either; each of its student streams
    (per chunk) gets one int64 seed for its dropout masks, ``{"dropout":
    seed}``, drawn first."""
    cfg = detector.cfg
    s = stream_flags(cfg)
    accum = grad_accum(cfg)
    canvas = resolve_canvas(cfg)
    aug = cfg.AUG

    def student(b, make):
        if accum == 1:
            return make(b)
        return [make(b // accum) for _ in range(accum)]

    if not _has_samplers(cfg):
        out = {}
        if cfg.MODEL.META_ARCHITECTURE == "DeformableDETR":
            def seed(_):
                return {"dropout": int(torch.randint(
                    0, 2**62, (), generator=gen, device=gen.device))}

            for name, on in (("weak", s.weak), ("strong", s.strong),
                             ("distill", s.distill)):
                if on:
                    out[name] = student(0, seed)
        if s.strong:
            out["aug_labeled"] = strong_aug_draws(
                gen, n_labeled, canvas, aug.LABELED_INCLUDE_RANDOM_ERASING,
                aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
        if s.distill:
            out["aug_unlabeled"] = strong_aug_draws(
                gen, n_unlabeled, canvas,
                aug.UNLABELED_INCLUDE_RANDOM_ERASING, aug.UNLABELED_MIC_AUG,
                aug.MIC_BLOCK_SIZE)
        return to_device(out, detector.device)
    n_anchors = detector.anchors_cat.shape[0]
    rpn = detector.rpn_params
    k_rpn = min(rpn["batch_size_per_image"], n_anchors)
    # the ROI sampler's candidates: the RPN's train proposals, or under
    # MODEL.LOAD_PROPOSALS the file's top PRECOMPUTED_PROPOSAL_TOPK_TRAIN,
    # and the appended gt slots
    n_cand = (cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN
              if cfg.MODEL.LOAD_PROPOSALS
              else cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN) + (
        cfg.TPU.MAX_GT if cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT else 0)

    def anchors(b):
        """The draws of the sampled anchor set (the teacher's distill
        anchors, TPU.RPN_LOSS_IMPL "sampled")."""
        return subsample_indices_draws(gen, (b,), n_anchors, k_rpn,
                                       rpn["positive_fraction"])

    def rpn_loss(b):
        """The draws of the student's RPN loss: none without the RPN
        (MODEL.LOAD_PROPOSALS), every anchor's for the dense loss."""
        if cfg.MODEL.LOAD_PROPOSALS:
            return {}
        if cfg.TPU.RPN_LOSS_IMPL != "sampled":
            return {"rpn": subsample_labels_draws(gen, (b,), n_anchors)}
        return {"rpn": anchors(b)}

    keep = detector.module.backbone.keep_rates()
    if keep is not None:
        keep = keep.to(gen.device)

    def drop(out, b):
        # drop-path keep masks [*keep.shape, B]: [2 (attention, MLP),
        # depth, B] for a ViT, [sum(depths), B] for a ConvNeXt
        if keep is not None:
            out["drop"] = torch.rand(keep.shape + (b,), generator=gen,
                                     device=gen.device) < keep[..., None]
        return out

    def chunk(b):
        return drop({**rpn_loss(b),
                     "roi": sample_proposals_draws(gen, (b,), n_cand)}, b)

    def align_chunk(b):
        out = {}
        if cfg.DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED:
            n = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + int(
                cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT)
            out["roi"] = sample_proposals_draws(gen, (b,), n)
        return drop(out, b)

    out = {}
    if s.weak:
        out["weak"] = student(n_labeled, chunk)
    if s.strong:
        out["strong"] = student(n_labeled, chunk)
        out["aug_labeled"] = strong_aug_draws(
            gen, n_labeled, canvas, aug.LABELED_INCLUDE_RANDOM_ERASING,
            aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
    if s.align:
        out["align"] = student(n_unlabeled, align_chunk)
    if s.distill:
        if s.teacher_anchors:
            out["teacher"] = anchors(n_unlabeled)
        out["distill"] = student(n_unlabeled, chunk)
        out["aug_unlabeled"] = strong_aug_draws(
            gen, n_unlabeled, canvas, aug.UNLABELED_INCLUDE_RANDOM_ERASING,
            aug.UNLABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)
    return to_device(out, detector.device)


def _has_samplers(cfg) -> bool:
    """The R-CNN families sample anchors and ROIs; YOLO and DETR sample
    nothing."""
    return cfg.MODEL.META_ARCHITECTURE == "GeneralizedRCNN"


def to_device(tree, device):
    """A nested dict (or list) of tensors moved to ``device``; other leaves
    (DETR's dropout seeds) as they are."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _chunk(tree, i: int, k: int):
    """Chunk i of k along the batch axis of every tensor of a nested dict,
    list or ``Instances``."""
    if tree is None or k == 1:
        return tree
    if isinstance(tree, dict):
        return {key: _chunk(v, i, k) for key, v in tree.items()}
    if isinstance(tree, list):
        return [_chunk(v, i, k) for v in tree]
    if isinstance(tree, Instances):
        return Instances(*(_chunk(getattr(tree, f), i, k) for f in
                           ("boxes", "classes", "valid", "scores")))
    b = tree.shape[0]
    if b % k:
        raise ValueError(
            f"batch dim {b} not divisible by TPU.GRAD_ACCUM={k}")
    return tree[i * (b // k):(i + 1) * (b // k)]


def make_train_step(cfg, detector):
    """The step ``(state, batch, draws) -> (state, metrics)`` for this
    config's stream composition. Metrics carry the weighted losses under
    the JAX package's keys (``loss_*_source_strong``, ``loss_*_distill``,
    ``loss_da_*_target_weak``, ...), ``total_loss`` and, with distillation,
    ``num_pseudo_labels``."""
    s = stream_flags(cfg)
    if cfg.MODEL.LOAD_PROPOSALS and (s.align or s.distill):
        # precomputed proposals replace the RPN outright; the DA streams
        # (pseudo-labels, alignment) need live proposals on unlabeled
        # images, which no proposal file covers (as in the JAX package)
        raise NotImplementedError(
            "MODEL.LOAD_PROPOSALS is supervised-only (Fast-R-CNN "
            "training); disable DOMAIN_ADAPT align/distill streams")
    accum = grad_accum(cfg)
    active = [n for n, on in (("weak", s.weak), ("strong", s.strong),
                              ("align", s.align), ("distill", s.distill))
              if on]
    threshold = cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD
    max_gt = cfg.TPU.MAX_GT
    aug = cfg.AUG

    def train_step(state: TrainState, batch: dict, draws: dict, mark=None):
        """``mark``, if given, is called with a stage's name as each stage
        ends (for timing by stage). Under a profiler each stage is the
        range ``aldi/step/<its name>`` (``utils/tracing.py``)."""
        def done(stage):
            if mark is not None:
                mark(stage)

        metrics = {}
        if s.ema:
            with span("step/ema update"):
                ema_update(state.teacher, state.student, cfg.EMA.ALPHA,
                           state.step, cfg.EMA.START_ITER)
            done("ema update")
        teacher = state.teacher if s.ema else state.student
        student = state.student

        lab, uw = batch.get("labeled"), batch.get("unlabeled")
        n_ls = lab["image"].shape[0] if (s.weak or s.strong) else 0
        n_lw = n_ls if s.weak else 0
        n_uw = uw["image"].shape[0] if (s.align or s.distill) else 0
        n_eff = max(n_lw + (n_ls if s.strong else 0) + n_uw, 1)

        ctx = pseudo = None
        if s.distill:
            with span("step/teacher (pseudo-labels, distill targets)"):
                ctx, pseudo, t_metrics = detector.forward_teacher_ctx(
                    teacher, uw["image"], uw["sizes"], draws.get("teacher"),
                    threshold=threshold, max_gt=max_gt)
            metrics.update(t_metrics)
            done("teacher (pseudo-labels, distill targets)")
        with span("step/strong views"), torch.no_grad():
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
        full = {"lab": lab, "gt": gt, "ls": ls_images if s.strong else None,
                "uw": uw if (s.align or s.distill) else None,
                "us": us_images if s.distill else None,
                "pseudo": pseudo, "ctx": ctx}

        def weighted(losses, suffix, weight):
            return {f"{k}_{suffix}": v * weight for k, v in losses.items()}

        def stream(name, m, d):
            """Stream ``name``'s weighted losses on chunk ``m`` with its
            draws ``d``."""
            # MODEL.LOAD_PROPOSALS: the labeled batch's proposals
            pre = ({"precomputed": {"boxes": m["lab"]["pboxes"],
                                    "valid": m["lab"]["pvalid"]}}
                   if m["lab"] is not None and "pboxes" in m["lab"] else {})
            if name == "weak":
                losses, _ = detector.forward_train(
                    student, m["lab"]["image"], m["lab"]["sizes"], m["gt"],
                    d.get("weak"), do_align=s.align, domain_label=1.0, **pre)
                return weighted(losses, "source_weak", n_lw / n_eff)
            if name == "strong":
                losses, _ = detector.forward_train(
                    student, m["ls"], m["lab"]["sizes"], m["gt"],
                    d.get("strong"), do_align=s.align, domain_label=1.0,
                    **pre)
                return weighted(losses, "source_strong", n_ls / n_eff)
            if name == "align":
                losses = detector.forward_domain_align(
                    student, m["uw"]["image"], m["uw"]["sizes"],
                    d.get("align"), domain_label=0.0)
                return weighted(losses, "target_weak", n_uw / n_eff)
            std, s_aux = detector.forward_train(
                student, m["us"], m["uw"]["sizes"], m["pseudo"],
                d.get("distill"))
            if getattr(detector, "gate_hard", True):
                losses = gate_hard_losses(std, cfg)
            else:  # HardDistiller: the standard losses pass through
                losses = dict(std)
            if s.soft:
                losses.update(detector.distill_losses(teacher, m["ctx"],
                                                      s_aux))
            return weighted(losses, "distill", n_uw / n_eff)

        def total_of(losses):
            return sum(v.to(torch.float32) for v in losses.values())

        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_dict = {}
        total = 0.0
        for c in range(accum):
            m = _chunk(full, c, accum)
            d = draws if accum == 1 else {
                n: draws[n][c] for n in active if n in draws}
            at = f" (chunk {c + 1} of {accum})" if accum > 1 else ""
            if cfg.SOLVER.BACKWARD_AT_END or len(active) <= 1:
                label = "streams fwd + one bwd" + at
                with span("step/" + label):
                    losses = {}
                    for name in active:
                        losses.update(stream(name, m, d))
                    t_c = total_of(losses)
                    (t_c / accum).backward()
                done(label)
            else:  # one backward per stream: peak memory of one stream
                losses, t_c = {}, 0.0
                for name in active:
                    label = f"{name} stream fwd+bwd" + at
                    with span("step/" + label):
                        l_s = stream(name, m, d)
                        if l_s:  # DETR's alignment is a pass-through
                            t_s = total_of(l_s)
                            (t_s / accum).backward()
                            t_c = t_c + t_s.detach()
                            losses.update(l_s)
                    if l_s:  # a pass-through's range has no mark
                        done(label)
            total = total + t_c.detach() / accum
            for k, v in losses.items():
                v = v.detach() / accum
                loss_dict[k] = loss_dict[k] + v if k in loss_dict else v
        with span("step/optimizer"):
            params = [p for g in opt.param_groups for p in g["params"]]
            for p in params:
                if p.grad is None:
                    # a parameter no loss reached (the RPN head under
                    # MODEL.LOAD_PROPOSALS): JAX's zero gradient, which
                    # weight decay and momentum still move
                    p.grad = torch.zeros_like(p)
            all_reduce_grads(params)
            clip_gradients(cfg, params)
            set_lr(opt, state.schedule(state.step))
            opt.step()
            state.step += 1
        done("optimizer")

        metrics.update(loss_dict)
        metrics["total_loss"] = total
        return state, metrics

    return train_step
