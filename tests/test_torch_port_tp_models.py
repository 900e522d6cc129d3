"""Tensor parallelism (``aldi_tpu_torch/parallel/tensor.py``) on every
family's tiny step and on inference, at M = 2 on two gloo ranks
(``tests/torch_port_dist.py``, ``tests/torch_port_grid.py``), against the
port's world-1 step on the same batch and draws. No JAX compile: JAX only
shapes the seeded weights (``jax.eval_shape``).

- The DAOD step: the flagship's tiny aligned recipe of
  ``tests/test_torch_port_ddp.py`` (ResNet-26, canvas 128, saturated
  samplers, both discriminators, 4 + 4 images), two steps. The teacher's
  box head runs through the split matmuls, so its pseudo-labels pass the
  same gates only while no score sits within the reduction order's last
  bits of TEACHER.THRESHOLD; at these seeds none does, and the step is
  compared as world 1's (the JAX test checks its own TP DAOD step as a
  smoke test only, ``tests/test_tensor_parallel.py:107-112``).
- ViTDet (the tiny ViT with 4 heads, so each rank runs 2 of each block's
  heads; its global block on the plain K3 path), ConvNeXt (``pwconv1``/
  ``pwconv2`` split, the layer scale after the reduce) and Deformable DETR
  with TRANSFORMER.DROPOUT 0.1 (each FFN's hidden dropout on the rank's
  columns of world 1's mask): each family's DAOD recipe, one step.
- Inference (``tests/test_tensor_parallel.py:291-340``): the tiny burn-in
  R-CNN's and the tiny ViTDet's ``forward_inference`` on 8 images with the
  split student give world 1's detection sets per image.

Tolerances: losses 1e-5 relative and parameters 1e-4, as
``tests/test_torch_port_tp.py`` holds the burn-in step; world 1's student
moves by 1.0e-2 to 3.2e-2. Measured (the worst of two steps for the DAOD
step): losses 2.6e-7 (R-CNN DAOD), 5.8e-7 (ViTDet), 3.0e-7 (ConvNeXt),
1.3e-7 (DETR); parameters 3.0e-8, 1.2e-7, 1.2e-7, 6.0e-8. Detections:
scores 1e-4 relative, boxes 1e-3, as the JAX test; measured 8.3e-7 and
2.3e-5 absolute.
"""

import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import draw_step
from aldi_tpu_torch.models import build_detector
from tests import torch_port_dist as dist_run
from tests import torch_port_draws as draws_from
from tests import torch_port_grid as grid
from tests.test_torch_port_convnext import convnext_cfg, convnext_variables
from tests.test_torch_port_ddp import global_batch, setup
from tests.test_torch_port_tp import (LOSS_RTOL, PARAM_ATOL, burnin_cfg,
                                      loss_err, param_err, set_keys)
from tests.test_torch_port_train_step import torch_tree
from tests.test_torch_port_vit_train import vit_cfg, vit_variables
from tests.torch_port_common import (VIT_TINY, detr_cfg, detr_variables,
                                     seeded_variables, tiny_images, tiny_vit,
                                     vitdet_head_config, tiny_cfg)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

VIT = dict(VIT_TINY, num_heads=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 runs on one thread, as each spawned rank:
    the same sums in the same order but for the split ones."""
    with torch_threads(1):
        yield


def check_step(label, world1, ranks, start):
    """The two model ranks' steps against world 1's: every step's losses,
    the parameters after the last (world 1's student moved by at least 10
    x the tolerance from ``start``); the ranks' replicated parameters
    bitwise equal."""
    lerr = max(loss_err(r, w) for r, w in zip(ranks[0][0]["metrics"],
                                               world1["metrics"]))
    perr = param_err(ranks[0][0]["student"], world1["student"])
    terr = param_err(ranks[0][0]["teacher"], world1["teacher"])
    moved = param_err(world1["student"], start)
    split = [n for n, s in ranks[0][0]["bytes"]["shards"].items()
             if s[0] == "model"]
    print(f"{label}: losses {lerr:.3g} relative (tol {LOSS_RTOL}), "
          f"student {perr:.3g}, teacher {terr:.3g} (tol {PARAM_ATOL}); "
          f"{len(split)} parameters split; the student moved {moved:.3g}")
    assert split and moved >= 10 * PARAM_ATOL
    assert lerr <= LOSS_RTOL and max(perr, terr) <= PARAM_ATOL
    a, b = ranks[0][0]["replicated"], ranks[1][0]["replicated"]
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_daod_step_at_m2_equals_world1(tmp_path):
    """The tiny aligned DAOD step, twice, with pseudo-labels on both
    ranks."""
    _, tcfg, variables, batches, rngs = setup(1)
    weights = jax_variables_to_state_dict(variables)
    n_anchors = build_detector(tcfg, device="cpu").anchors_cat.shape[0]
    draws = [draws_from.train_step_draws(r, tcfg, 4, 4, n_anchors)
             for r in rngs]
    tb = [torch_tree(b) for b in batches]
    cfg = dist_run.portable(tcfg)
    world1 = grid.steps(cfg, weights, tb, draws)
    ranks = dist_run.run_ranks(grid.grid_steps, 2, tmp_path, 2, cfg,
                               weights, tb, draws)
    assert world1["metrics"][0]["num_pseudo_labels"] > 0
    assert all(r[0]["metrics"][i]["num_pseudo_labels"]
               == world1["metrics"][i]["num_pseudo_labels"]
               for r in ranks for i in range(2))
    check_step("R-CNN DAOD, M=2", world1, ranks, weights)


def family(name):
    """(port cfg, world 1's weights, the ViT config) of a family's recipe
    at its tiny size, with SGD: ADAMW's first update, lr g / (|g| + eps),
    turns the last bits of a gradient near eps (1e-8) into up to lr, which
    hides no error of the split but swamps the parameters' tolerance
    (``tests/test_torch_port_fsdp.py`` steps ADAMW's moments). The
    learning rate makes the student move by more than 10 x the tolerance
    (DETR's gradients are clipped to the global norm 0.1)."""
    sgd = {"SOLVER.OPTIMIZER": "SGD",
           "SOLVER.BASE_LR": {"vit": 0.05, "convnext": 0.05}.get(name, 5.0)}
    if name == "vit":
        with tiny_vit(num_heads=4):
            jcfg = vit_cfg(jax_get_cfg)
            variables = vit_variables(jax_build_detector(jcfg), seed=3)
        tcfg, vit = vit_cfg(port_get_cfg), VIT
    elif name == "convnext":
        jcfg, tcfg = convnext_cfg(jax_get_cfg), convnext_cfg(port_get_cfg)
        variables = convnext_variables(jax_build_detector(jcfg), seed=3)
        vit = None
    else:
        over = {"MODEL.DEFORMABLE_DETR.TRANSFORMER.DROPOUT": 0.1,
                "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.0}
        jcfg = detr_cfg(jax_get_cfg, **over)
        tcfg = detr_cfg(port_get_cfg, **over)
        variables = detr_variables(jax_build_detector(jcfg), seed=3)
        vit = None
    return (set_keys(tcfg, **sgd), jax_variables_to_state_dict(variables),
            vit)


@pytest.mark.parametrize("name", ["vit", "convnext", "detr"])
def test_family_step_at_m2_equals_world1(tmp_path, name):
    """One DAOD step of the family's recipe at M = 2 against world 1, on
    draws made once (drop path masks, DETR's dropout seeds)."""
    tcfg, weights, vit = family(name)
    with tiny_vit(num_heads=4):
        det = build_detector(tcfg, device="cpu")
        draws = [draw_step(torch.Generator().manual_seed(5), det, 4, 4)]
        batches = [torch_tree(global_batch(7))]
        cfg = dist_run.portable(tcfg)
        world1 = grid.steps(cfg, weights, batches, draws)
    ranks = dist_run.run_ranks(grid.grid_steps, 2, tmp_path, 2, cfg,
                               weights, batches, draws, (None,), 1, vit)
    check_step(f"{name}, M=2", world1, ranks, weights)


def inference_case(name):
    if name == "rcnn":
        jcfg, tcfg = burnin_cfg(jax_get_cfg), burnin_cfg(port_get_cfg)
        canvas = (64, 64)
    else:
        jcfg = vitdet_head_config(tiny_cfg(jax_get_cfg))
        tcfg = vitdet_head_config(tiny_cfg(port_get_cfg))
        canvas = (128, 128)
    with tiny_vit(num_heads=4):
        variables = seeded_variables(jax_build_detector(jcfg), seed=0)
    images = np.concatenate([tiny_images(2, canvas, seed=s)[0]
                             for s in range(4)])
    sizes = np.tile(tiny_images(2, canvas)[1], (4, 1))
    return (tcfg, jax_variables_to_state_dict(variables),
            torch.from_numpy(images), torch.from_numpy(sizes))


@pytest.mark.parametrize("name", ["rcnn", "vit"])
def test_inference_at_m2_gives_world1_detections(tmp_path, name):
    """The split student's detections on 8 images are world 1's: per image
    the same count (within one), score-sorted scores, classes and
    boxes."""
    tcfg, weights, images, sizes = inference_case(name)
    cfg = dist_run.portable(tcfg)
    with tiny_vit(num_heads=4):
        want = grid.inference(cfg, weights, images, sizes)
    ranks = dist_run.run_ranks(grid.grid_inference, 2, tmp_path, 2, cfg,
                               weights, images, sizes, VIT)
    worst = {"scores": 0.0, "boxes": 0.0}
    n_det = 0
    for got in ranks:
        boxes_g, scores_g, classes_g, valid_g = got
        boxes_w, scores_w, classes_w, valid_w = want
        for i in range(boxes_w.shape[0]):
            d, t = valid_w[i].astype(bool), valid_g[i].astype(bool)
            assert abs(int(d.sum()) - int(t.sum())) <= 1
            n = min(int(d.sum()), int(t.sum()))
            n_det += n
            od = np.argsort(-scores_w[i][d])[:n]
            ot = np.argsort(-scores_g[i][t])[:n]
            np.testing.assert_allclose(scores_g[i][t][ot], scores_w[i][d][od],
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_array_equal(classes_g[i][t][ot],
                                          classes_w[i][d][od])
            np.testing.assert_allclose(boxes_g[i][t][ot], boxes_w[i][d][od],
                                       rtol=1e-3, atol=1e-3)
            if n:
                worst["scores"] = max(worst["scores"], float(np.max(np.abs(
                    scores_g[i][t][ot] - scores_w[i][d][od]))))
                worst["boxes"] = max(worst["boxes"], float(np.max(np.abs(
                    boxes_g[i][t][ot] - boxes_w[i][d][od]))))
    print(f"{name} inference at M=2: {n_det} detections compared, worst "
          f"score {worst['scores']:.3g}, box {worst['boxes']:.3g}")
    assert n_det > 0
