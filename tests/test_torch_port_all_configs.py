"""One port training step for each protocol class of the config corpus, on
the CPU: the port's counterpart of ``tests/test_all_configs.py:117``.

The classes and their shrink rules are that file's: its
``CLASS_REPRESENTATIVES`` (one YAML of each combination of
meta-architecture, stream composition, DA flags, optimizer and EMA, 12 in
all) and ``_shrink_for_step`` (canvas 64, MAX_GT 4, ResNet-26, ConvNeXt
depths 1/1/1/1, top-k 64/32, 16 ROIs, 50 DETR queries, one image per
stream).

- The four classes that train on ``labeled_weak`` alone with EMA off
  (``Base-RCNN-FPN``, ``Base-RCNN-ConvNeXt-FPN``, ``Base-Yolo``,
  ``Base-DETR``) have no parity test elsewhere: each step is held against
  the JAX package's jitted step on the same seeded weights, batch and
  draws (the JAX step's own keys, through ``tests/torch_port_draws.py``).
  For that both packages compute in float32 (TPU.COMPUTE_DTYPE: under
  SOLVER.AMP each framework rounds bfloat16 at other places) and DETR
  without dropout (each package draws its own masks) and with 2 + 2
  layers in place of 6 + 6 (the depth of the DETR parity tests; the JAX
  step's compile at 6 + 6, about 60 s, would take the file past its
  budget of 150 s on one worker, and the class is about its streams and
  losses, not its depth). Tolerance: every
  logged metric, ``total_loss`` and each loss, to 1e-4 relative, the
  convention of ``tests/test_torch_port_train_step.py`` (float32
  convolutions and matrix products sum in another order in each
  framework, about 1e-6 relative per layer).
- The other eight have parity tests of their own (the flagship, ConvNeXt,
  YOLO and DETR DAOD steps): each runs its port step on seeded weights
  (``chip_smoke.seeded_weights``: at the reference's initialization some
  parameters get no gradient in a first step, such as DETR's
  ``level_embed`` behind the zeroed sampling offsets and attention
  weights) and ``draw_step``'s draws, and the step must give a finite
  loss and advance the step count.

Every step must move the trainable parameters and leave the frozen ones
(``requires_grad`` False: the frozen stem and res2) as they were.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.engine.train_step import TrainState as JaxTrainState
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from chip_smoke import seeded_weights
from tests import torch_port_draws as draws_from
from tests.test_all_configs import (CLASS_REPRESENTATIVES, CONFIG_ROOT,
                                    _shrink_for_step)
from tests.torch_port_common import (detr_variables, seeded_variables,
                                     yolo_variables)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

HELD_AGAINST_JAX = ("Base-DETR.yaml", "Base-RCNN-ConvNeXt-FPN.yaml",
                    "Base-RCNN-FPN.yaml", "Base-Yolo.yaml")
VARIABLES = {"GeneralizedRCNN": seeded_variables, "Yolo": yolo_variables,
             "DeformableDETR": detr_variables}


def class_cfg(get_cfg, rel, held):
    """``rel`` loaded and shrunk by ``_shrink_for_step``; for a class held
    against JAX, in float32 and (DETR) without dropout."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIG_ROOT, rel))
    _shrink_for_step(cfg)
    if held:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        t = cfg.MODEL.DEFORMABLE_DETR.TRANSFORMER
        t.DROPOUT = 0.0
        t.ENC_LAYERS = t.DEC_LAYERS = 2
    return cfg


def with_unlabeled(cfg):
    return (any(s.startswith("unlabeled")
                for s in cfg.DATASETS.BATCH_CONTENTS)
            and len(cfg.DATASETS.UNLABELED) > 0)


def make_batch(cfg, seed):
    """One labeled image (3 gt boxes of the config's classes, a fourth slot
    empty) and, where the class has an unlabeled stream, one unlabeled
    image; else an empty unlabeled stream, as the JAX test feeds."""
    rng = np.random.default_rng(seed)
    h, w = cfg.TPU.CANVAS
    g = cfg.TPU.MAX_GT
    num_classes = {"Yolo": cfg.MODEL.YOLO.NUM_CLASSES,
                   "DeformableDETR": cfg.MODEL.DEFORMABLE_DETR.NUM_CLASSES
                   }.get(cfg.MODEL.META_ARCHITECTURE,
                         cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    boxes = np.zeros((1, g, 4), np.float32)
    xy = rng.uniform(0, [w - 24, h - 24], (3, 2))
    wh = rng.uniform(12, 24, (3, 2))
    boxes[0, :3] = np.concatenate([xy, xy + wh], 1)
    valid = np.zeros((1, g), bool)
    valid[0, :3] = True
    n_u = 1 if with_unlabeled(cfg) else 0
    return {
        "labeled": {
            "image": rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32),
            "sizes": np.array([[h, w]], np.int32), "boxes": boxes,
            "classes": rng.integers(0, num_classes, (1, g)).astype(np.int32),
            "valid": valid},
        "unlabeled": {
            "image": rng.uniform(0, 255, (n_u, h, w, 3)).astype(np.float32),
            "sizes": np.tile(np.array([[h, w]], np.int32), (n_u, 1))},
    }


def tree(t, leaf):
    if isinstance(t, dict):
        return {k: tree(v, leaf) for k, v in t.items()}
    return leaf(t)


def jax_step(cfg, jdet, variables, batch, rng):
    """The JAX package's jitted step from ``variables`` (EMA off): its
    metrics and its step count after the step."""
    params = tree(variables["params"], jnp.asarray)
    tx = jax_build_optimizer(cfg, params)
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        frozen=tree(variables.get("frozen", {}), jnp.asarray),
        opt_state=tx.init(params), ema_params=None,
        model_state={k: tree(v, jnp.asarray) for k, v in variables.items()
                     if k not in ("params", "frozen")},
        ema_model_state=None)
    state, m = jax_make_train_step(cfg, jdet, tx)(
        state, tree(batch, jnp.asarray), rng)
    return {k: float(v) for k, v in m.items()}, int(state.step)


def weak_draws(rng, cfg, jdet, variables, n_anchors):
    """The draws of the JAX step's labeled_weak stream (``keys[3]`` of its
    ten), keyed as the port's ``draw_step`` keys them: the R-CNN's anchor
    and ROI samplers' (and ConvNeXt's drop-path masks), DETR's dropout seed
    (unused without dropout); YOLO draws nothing."""
    k_weak = jax.random.split(rng, 10)[3]
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch == "GeneralizedRCNN":
        drop = None
        if cfg.MODEL.BACKBONE.NAME == "build_convnext_fpn_backbone":
            drop = functools.partial(draws_from.convnext_drop_masks, jdet,
                                     variables)
        return {"weak": draws_from.forward_train_draws(k_weak, cfg, 1,
                                                       n_anchors, drop)}
    if arch == "DeformableDETR":
        return {"weak": {"dropout": 0}}
    return {}


def port_step(cfg, det, batch, draws, weights=None):
    """One port step: (metrics, step count, parameters before and after,
    the names of the trainable ones)."""
    state = create_train_state(cfg, det, weights)
    before = {k: p.detach().clone()
              for k, p in state.student.named_parameters()}
    trainable = {k for k, p in state.student.named_parameters()
                 if p.requires_grad}
    state, m = make_train_step(cfg, det)(
        state, tree(batch, torch.from_numpy), draws)
    after = {k: p.detach() for k, p in state.student.named_parameters()}
    return ({k: float(v) for k, v in m.items()}, state.step, before, after,
            trainable)


def close_rel(got, want, what, rtol=1e-4):
    print(f"{what}: {got:.6g} vs {want:.6g}")
    assert abs(got - want) <= rtol * max(abs(want), 1e-3), what


def test_the_held_classes_are_the_weak_only_classes_without_ema():
    """The classes held against JAX are exactly the corpus's
    labeled_weak-only, EMA-off classes."""
    held = []
    for rel in CLASS_REPRESENTATIVES:
        cfg = class_cfg(port_get_cfg, rel, held=False)
        if (tuple(cfg.DATASETS.BATCH_CONTENTS) == ("labeled_weak",)
                and not cfg.EMA.ENABLED):
            held.append(rel)
    assert len(CLASS_REPRESENTATIVES) == 12
    assert tuple(held) == HELD_AGAINST_JAX


@pytest.mark.parametrize("rel", CLASS_REPRESENTATIVES)
def test_config_class_runs_one_port_step(rel):
    held = rel in HELD_AGAINST_JAX
    tcfg = class_cfg(port_get_cfg, rel, held)
    batch = make_batch(tcfg, seed=3)
    if held:
        jcfg = class_cfg(jax_get_cfg, rel, held)
        jdet = jax_build_detector(jcfg)
        variables = jax.tree_util.tree_map(
            np.asarray,
            VARIABLES[jcfg.MODEL.META_ARCHITECTURE](jdet, seed=5))
        det = build_detector(tcfg, device="cpu")
        rng = jax.random.PRNGKey(7)
        n_anchors = (det.anchors_cat.shape[0]
                     if hasattr(det, "anchors_cat") else 0)
        draws = weak_draws(rng, tcfg, jdet, variables, n_anchors)
        got, steps, before, after, trainable = port_step(
            tcfg, det, batch, draws, jax_variables_to_state_dict(variables))
        want, jax_steps = jax_step(jcfg, jdet, variables, batch, rng)
        assert jax_steps == 1
        assert set(got) == set(want), set(got) ^ set(want)
        assert any(k.startswith("loss") for k in want)
        for k in sorted(want):
            close_rel(got[k], want[k], f"{rel} {k}")
    else:
        det = build_detector(tcfg, device="cpu")
        draws = draw_step(torch.Generator().manual_seed(7), det, 1,
                          batch["unlabeled"]["image"].shape[0])
        got, steps, before, after, trainable = port_step(
            tcfg, det, batch, draws, seeded_weights(det, seed=5))
    print(f"{rel}: total_loss {got['total_loss']:.6g}")
    assert math.isfinite(got["total_loss"]) and steps == 1
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    print(f"{rel}: {len(moved)} of {len(trainable)} trainable parameters "
          f"moved; {len(after) - len(trainable)} frozen")
    assert moved == trainable, (sorted(trainable - moved)[:5],
                                sorted(moved - trainable)[:5])
