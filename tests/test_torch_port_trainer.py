"""The port's trainer (``aldi_tpu_torch/engine/trainer.py``) on the CPU, at
the tiny config of ``tests/test_torch_port_train_step.py`` (ResNet-26,
canvas 128, 3 classes, float32) on ``tests/synthetic_data.py`` datasets
registered in both packages' catalogs.

Against the JAX package, with the same seeded weights, the same batch (the
JAX loader's batch 0, which the port's loader reproduces exactly) and the
same draws (the JAX step's own, through ``tests/torch_port_draws.py``):
one DAOD step with ``TPU.GRAD_ACCUM`` 2 against ``aldi_tpu``'s jitted step
with ``TPU.GRAD_ACCUM`` 2, and the trainer's first iteration (its draws
substituted) against the same step. Tolerances as in
``test_torch_port_train_step.py``: losses 1e-4 relative, parameters 1e-5
absolute. The port alone: burn-in and DAOD runs write their metrics,
checkpoints and AP; 2 + resume + 2 iterations are bit-equal to 4 straight
(weights, teacher, momentum); a NaN loss raises; resume restores the
best-AP50 map; no GPU means no trainer unless the CPU is asked for.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.data.loader import WeakStrongLoader as JaxWeakStrongLoader
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import (create_train_state,
                                              make_train_step)
from aldi_tpu_torch.engine.trainer import ALDITrainer
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.utils import events
from tests import torch_port_draws as draws_from
from tests.test_torch_port_train_step import (close_rel, daod_cfg, jax_tree,
                                              torch_tree)
from tests.torch_port_common import (drop_weight_files, loader_cfg,
                                     max_err, register_synthetic_both,
                                     seeded_variables)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

SEED = 7
LOSS_KEYS = {"num_pseudo_labels", "total_loss", "loss_rpn_cls_source_strong",
             "loss_rpn_loc_source_strong", "loss_cls_source_strong",
             "loss_box_reg_source_strong", "loss_rpn_cls_distill",
             "loss_rpn_loc_distill", "loss_cls_distill",
             "loss_box_reg_distill", "loss_obj_bce_distill",
             "loss_rpn_l1_distill", "loss_cls_ce_distill",
             "loss_roih_l1_distill"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def no_weights_left(tmp_path):
    yield
    drop_weight_files(tmp_path)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The writers without TensorBoard, as where it is not installed: its
    first event write imports TensorFlow here, about 20 s."""
    def unavailable(*args):
        raise ImportError("TensorBoard left out of the tests")

    monkeypatch.setattr(events, "TensorBoardWriter", unavailable)


@pytest.fixture(scope="module")
def names(tmp_path_factory):
    return register_synthetic_both(tmp_path_factory.mktemp("data"),
                                   "port_trainer")


def trainer_cfg(get_cfg, names, out, saturated=False, **overrides):
    """The tiny DAOD config with the synthetic datasets: 2 labeled + 2
    unlabeled images per step, no eval and no periodic checkpoint unless
    overridden."""
    cfg = loader_cfg(daod_cfg(get_cfg, saturated=saturated), names)
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.DEVICE = "cpu"
    cfg.OUTPUT_DIR = str(out)
    cfg.SEED = SEED
    cfg.TEST.EVAL_PERIOD = 0
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.VIS_PERIOD = 0
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def metrics_lines(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def accum_case(names, tmp_path_factory):
    """One saturated DAOD step of the JAX package with TPU.GRAD_ACCUM 2 on
    its loader's batch 0, and what the port needs to repeat it."""
    out = tmp_path_factory.mktemp("accum")
    over = {"TPU.GRAD_ACCUM": 2}
    jcfg = trainer_cfg(jax_get_cfg, names, out, saturated=True, **over)
    tcfg = trainer_cfg(port_get_cfg, names, out, saturated=True, **over)
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed=5)
    batch = next(JaxWeakStrongLoader(jcfg, jdet.canvas, seed=SEED))
    rng = jax.random.PRNGKey(41)
    state, tx = jax_create_train_state(jcfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params,
                          frozen=jax_tree(dict(variables["frozen"])),
                          opt_state=tx.init(params),
                          ema_params=jax_tree(dict(variables["params"])))
    state, m = jax_make_train_step(jcfg, jdet, tx)(state, jax_tree(batch),
                                                  rng)
    want = {k: float(v) for k, v in m.items()}
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want_params = jax_variables_to_state_dict({"params": to_np(state.params)})
    n_anchors = build_detector(tcfg, device="cpu").anchors_cat.shape[0]
    draws = draws_from.train_step_draws(rng, tcfg, 2, 2, n_anchors)
    return tcfg, variables, batch, draws, want, want_params


def test_grad_accum_step_matches_jax(accum_case):
    """TPU.GRAD_ACCUM 2: the teacher pass and the strong views on the whole
    batch, two chunks per stream with their own draws, gradients summed at
    1/2, losses averaged, one optimizer step."""
    tcfg, variables, batch, draws, want, want_params = accum_case
    assert isinstance(draws["strong"], list) and len(draws["strong"]) == 2
    det = build_detector(tcfg, device="cpu")
    start = jax_variables_to_state_dict(variables)
    state = create_train_state(tcfg, det, start)
    state, got = make_train_step(tcfg, det)(state, torch_tree(batch), draws)
    assert set(got) == set(want) == LOSS_KEYS
    for k in want:
        close_rel(got[k], want[k], what=k)
    assert want["num_pseudo_labels"] > 0
    params = dict(state.student.named_parameters())
    err = max(max_err(params[k].detach().numpy(), want_params[k].numpy())
              for k in want_params)
    moved = max(max_err(want_params[k].numpy(), start[k].numpy())
                for k in want_params)
    print(f"parameters after the step: max abs err {err:.3g}, largest move "
          f"{moved:.3g}")
    assert err <= 1e-5 and moved >= 100 * 1e-5


def test_trainer_first_iteration_matches_jax(accum_case, tmp_path):
    """The trainer's first iteration, with the JAX draws substituted for
    its own, on its own loader's batch: the losses it writes to
    metrics.json are the JAX step's."""
    tcfg, variables, _, draws, want, _ = accum_case
    cfg = tcfg.clone()
    cfg.OUTPUT_DIR = str(tmp_path)
    cfg.SOLVER.MAX_ITER = 1
    trainer = ALDITrainer(cfg)
    weights = jax_variables_to_state_dict(variables)
    trainer.state.student.load_state_dict(weights)
    trainer.state.teacher.load_state_dict(weights)
    seen = []
    trainer.draws = lambda it, batch: seen.append(it) or draws
    assert trainer.train() == {}
    assert seen == [0]
    (line,) = metrics_lines(tmp_path)
    assert line["iteration"] == 1
    for k in want:
        close_rel(line[k], want[k], what=k)
    assert os.path.exists(tmp_path / "model_0000001.pth")


# ---------------------------------------------------------- the port alone
@pytest.mark.parametrize("recipe", ["burn-in", "daod"])
def test_trainer_writes_metrics_checkpoints_and_ap(names, tmp_path, recipe):
    over = {"SOLVER.MAX_ITER": 3, "SOLVER.CHECKPOINT_PERIOD": 2,
            "TEST.EVAL_PERIOD": 3}
    if recipe == "burn-in":  # Base-RCNN-FPN-*_strongaug_ema
        over.update({"DATASETS.UNLABELED": (),
                     "DATASETS.BATCH_CONTENTS": ("labeled_strong",),
                     "DATASETS.BATCH_RATIOS": (1,),
                     "SOLVER.IMS_PER_BATCH": 2})
    cfg = trainer_cfg(port_get_cfg, names, tmp_path, **over)
    trainer = ALDITrainer(cfg)
    evals = []
    test = trainer.test
    trainer.test = lambda *a: evals.append(trainer.state.step) or test(*a)
    results = trainer.train()
    assert evals == [3]  # no second trailing eval
    ap50 = results[names["val"]]["bbox/AP50"]
    assert np.isfinite(ap50)
    files = set(os.listdir(tmp_path))
    assert {"model_0000002.pth", "model_0000003.pth", "last_checkpoint",
            "trainer_state.json", f"{names['val']}_model_best.pth"} <= files
    lines = metrics_lines(tmp_path)
    assert [m["iteration"] for m in lines] == [1]  # the first write point
    keys = {"iteration", "total_loss", "images_per_sec", "data_time",
            "dispatch_time"}
    keys |= (LOSS_KEYS if recipe == "daod" else
             {k for k in LOSS_KEYS if "source" in k})
    assert keys == set(lines[0])
    assert all(np.isfinite(lines[0][k]) for k in keys)
    with open(tmp_path / "trainer_state.json") as f:
        assert json.load(f) == {"best_ap50": {names["val"]: ap50}}
    ckpt = torch.load(tmp_path / "model_0000003.pth", weights_only=True)
    assert set(ckpt) == {"model", "ema", "optimizer", "iteration",
                         "trainer_state", "__author__"}
    assert ckpt["iteration"] == 3
    assert set(ckpt["ema"]) == {f"model.{k}" for k in ckpt["model"]}
    # resume restores the best-AP50 map and the iteration
    again = ALDITrainer(cfg)
    again.resume_or_load(resume=True)
    assert again._best == {names["val"]: ap50}
    assert again.state.step == 3


def _state_tensors(trainer):
    s = trainer.state
    out = {f"student.{k}": v for k, v in s.student.state_dict().items()}
    out.update({f"teacher.{k}": v for k, v in s.teacher.state_dict().items()})
    for i, p in enumerate(s.student.parameters()):
        if p in s.optimizer.state:
            out[f"momentum.{i}"] = s.optimizer.state[p]["momentum_buffer"]
    return out


def test_resume_is_bit_equal(names, tmp_path):
    """2 iterations, a new trainer resumed from their checkpoint for 2 more:
    the student, the teacher and the momentum equal 4 straight iterations
    bit for bit (the data stream and the draws are functions of (SEED,
    it))."""
    straight_cfg = trainer_cfg(port_get_cfg, names, tmp_path / "straight",
                               **{"SOLVER.MAX_ITER": 4})
    straight = ALDITrainer(straight_cfg)
    straight.train()
    first = ALDITrainer(trainer_cfg(port_get_cfg, names, tmp_path / "split",
                                    **{"SOLVER.MAX_ITER": 2}))
    first.train()
    resumed = ALDITrainer(trainer_cfg(port_get_cfg, names,
                                      tmp_path / "split",
                                      **{"SOLVER.MAX_ITER": 4}))
    resumed.resume_or_load(resume=True)
    assert resumed.state.step == 2
    loaded, saved = _state_tensors(resumed), _state_tensors(first)
    assert set(loaded) == set(saved)
    assert all(torch.equal(loaded[k], saved[k]) for k in saved)
    resumed.train()
    want, got = _state_tensors(straight), _state_tensors(resumed)
    assert set(got) == set(want) and any(k.startswith("momentum") for k in
                                         want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert resumed.state.step == straight.state.step == 4


def test_nan_loss_raises(names, tmp_path):
    cfg = trainer_cfg(port_get_cfg, names, tmp_path,
                      **{"SOLVER.MAX_ITER": 2})
    trainer = ALDITrainer(cfg)
    with torch.no_grad():
        for p in trainer.state.student.roi_heads.parameters():
            p.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="iteration 0"):
        trainer.train()


def test_trainer_raises_without_a_card(names, tmp_path):
    """MODEL.DEVICE tpu (the YAMLs' default) or cuda means the card: without
    one the trainer raises instead of running on the CPU; a model axis
    wider than the group raises the JAX package's mesh error."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for device in ("tpu", "cuda"):
        cfg = trainer_cfg(port_get_cfg, names, tmp_path,
                          **{"MODEL.DEVICE": device})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ALDITrainer(cfg)
    cfg = trainer_cfg(port_get_cfg, names, tmp_path,
                      **{"TPU.MESH_MODEL": 2})
    with pytest.raises(ValueError, match="not divisible by TPU.MESH_MODEL"):
        ALDITrainer(cfg)
