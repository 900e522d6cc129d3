"""Data parallelism of the port's random draws along a batch axis, at world
size 2 on the CPU: Deformable DETR's dropout (one seed per stream and
chunk; a rank draws the chunk's whole masks and keeps its rows) and its
global ``num_boxes``, and ConvNeXt's drop-path keep masks ([sum(depths),
B]: the batch is the last axis). Two spawned gloo ranks
(``tests/torch_port_dist.py``) step on their shares of a global batch of
4 + 4 images with the port's draws for that batch (``draw_step``), against
the port's world-1 step on the whole batch.

The configs are the tiny DETR of ``tests/torch_port_common.py``
``detr_cfg`` with TRANSFORMER.DROPOUT 0.1 and TEACHER.THRESHOLD 0.045 (its
seeded scores lie in 0.037-0.064: 6, 7, 6 and 8 pseudo-labels on the
first batch's unlabeled images, none within 4e-4 of the threshold), and
the tiny ConvNeXt of ``tests/test_torch_port_convnext.py`` (drop path 0.5,
its layer-scale gammas set to O(1), else each block is the identity to six
digits and a wrong mask would not show), both with SGD: AdamW's first
steps are about lr * sign(g), so an entry whose gradient sits at float32
noise would move by up to lr either way. The labeled images carry 3, 4, 5
and 6 gt boxes.

Tolerances: losses 1e-4 relative, parameters after two steps 1e-5
absolute (SGD at lr 0.1 for DETR, 0.01 for the ConvNeXt; measured: the
losses 1.2e-6, the parameters 7.0e-7 and 3.0e-8, the students moving by
2e-3 and 1.2e-2); the ranks' parameters bitwise equal.
"""

import numpy as np
import pytest
import torch

from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.train_step import draw_step
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models.detr import _Dropout
from tests import torch_port_dist as dist_run
from tests.test_torch_port_convnext import convnext_cfg
from tests.test_torch_port_ddp import (check_metrics, check_params,
                                       global_batch, rank_sums)
from tests.test_torch_port_train_step import torch_tree
from tests.torch_port_common import detr_cfg
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 runs on one thread, as each spawned rank."""
    with torch_threads(1):
        yield


def world2_against_world1(cfg, weights, tmp_path, accum):
    """Two steps at world 1 and at world 2 on the same global batches and
    draws; checks and returns the world-2 ranks' metrics."""
    det = build_detector(cfg, device="cpu")
    gen = torch.Generator().manual_seed(11)
    draws = [draw_step(gen, det, 4, 4) for _ in range(2)]
    batches = [torch_tree(global_batch(s)) for s in (0, 1)]
    cfg_dict = dist_run.portable(cfg)
    m1, s1, t1 = dist_run.daod_steps(0, 1, cfg_dict, weights, batches,
                                     draws, accum)
    (r0, s0, t0), (r1, s_1, t_1) = dist_run.run_ranks(
        dist_run.daod_steps, 2, tmp_path, cfg_dict, weights, batches, draws,
        accum)
    for a, b in ((s0, s_1), (t0, t_1)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    check_metrics(rank_sums([r0, r1]), m1, 1e-4, "world 2 vs world 1")
    moved = max(float((s1[k] - weights[k]).abs().max()) for k in weights
                if s1[k].is_floating_point())
    print(f"the student's largest move: {moved:.3g}")
    assert moved >= 100 * 1e-5
    check_params(s0, s1, 1e-5, "world 2 vs world 1, student")
    check_params(t0, t1, 1e-5, "world 2 vs world 1, teacher")
    return draws, r0, r1


@pytest.mark.parametrize("accum", [1, 2])
def test_detr_world2_equals_world1(tmp_path, accum):
    """The dropout rows and the global ``num_boxes`` (the labeled stream's
    gt is uneven across the ranks; at TPU.GRAD_ACCUM 2 each rank holds one
    image of each chunk)."""
    cfg = detr_cfg(port_get_cfg, **{
        "SOLVER.OPTIMIZER": "SGD", "SOLVER.BASE_LR": 0.1,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.DROPOUT": 0.1,
        "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.045, "TPU.GRAD_ACCUM": accum})
    weights = dist_run.state_of(build_detector(cfg, device="cpu").module)
    draws, r0, r1 = world2_against_world1(cfg, weights, tmp_path, accum)
    seeds = draws[0]["strong"] if accum > 1 else [draws[0]["strong"]]
    assert all(isinstance(d["dropout"], int) for d in seeds)
    shares = [r[0]["num_pseudo_labels"] for r in (r0, r1)]
    print(f"num_pseudo_labels shares of the ranks: {shares}")
    assert shares[0] != shares[1] and min(shares) > 0
    assert r0[0]["loss_ce_distill"] > 0


def test_drop_path_world2_equals_world1(tmp_path):
    """ConvNeXt's keep masks [sum(depths), B], sliced on their last axis,
    at TPU.GRAD_ACCUM 2."""
    cfg = convnext_cfg(port_get_cfg)
    cfg.SOLVER.OPTIMIZER, cfg.SOLVER.BASE_LR = "SGD", 0.01
    cfg.TPU.GRAD_ACCUM = 2
    det = build_detector(cfg, device="cpu")
    rng = np.random.default_rng(3)
    weights = dist_run.state_of(det.module)
    for k in weights:
        if k.endswith("gamma"):
            weights[k] = torch.from_numpy(rng.uniform(
                0.5, 1.5, weights[k].shape).astype(np.float32))
    draws, _, _ = world2_against_world1(cfg, weights, tmp_path, 2)
    drop = draws[0]["strong"][0]["drop"]
    assert drop.shape == (5, 2) and not drop.all()


def test_dropout_rows_are_the_world1_masks_rows():
    """A rank's dropout masks are its rows of the masks the whole chunk
    draws at world 1, layer by layer and call by call."""
    x = torch.ones(4, 6, 8)
    whole = _Dropout(0.5, (7, 0, 1), 3, x.device)
    ranks = [_Dropout(0.5, (7, r, 2), 3, x.device) for r in (0, 1)]
    for _ in range(2):
        want = whole(x)
        got = torch.cat([d(x[:2]) for d in ranks])
        assert torch.equal(got, want)
    assert (want == 0).any() and (want != 0).any()
