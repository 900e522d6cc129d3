"""Port parity of the YOLOv5 DAOD step against the JAX package, on the
CPU, with the ALDI-Yolo recipe (``configs/cityscapes/ALDI-Yolo-Cityscapes
.yaml``: labeled_strong + distill, EMA, soft objectness, classification and
regression, no hard losses, erasing on the labeled stream and MIC on the
unlabeled one, Nesterov SGD, one backward per stream) cut to yolov5n, 3
classes, canvas 128, 2 + 2 images, MAX_GT 8, float32.

Both packages get the same seeded weights and BatchNorm statistics and the
same strong-view draws (the JAX step's own keys, through
``tests/torch_port_draws.py``); the JAX step runs jitted (its compile takes
about 30 s; un-jitted, flax dispatches every op of the network on its own
and is slower still). Two steps are compared, each: the losses, the
student's and the teacher's parameters, and the student's and the
teacher's BatchNorm running statistics (the JAX state's ``model_state`` and
``ema_model_state``), for the published recipe (one backward per stream);
``tests/test_torch_port_yolo_accum.py`` does the same with TPU.GRAD_ACCUM
2, SOLVER.BACKWARD_AT_END and image-level alignment. Then the port alone:
BACKWARD_AT_END keeps the statistics' order, the hard-loss gating against
the JAX package's, ``train_net`` with a resume, and the artifact.

Tolerances: losses 1e-4 relative (60 layers of float32 convolutions, each
summing in another order), running statistics and parameters 1e-4 of each
tensor's scale; after the second step the student's parameters 5e-4: its
gradient is taken at parameters that already differ by the first step's
rounding, which the 60 layers amplify (1.7e-4 measured, against 9e-6 after
the first step). The conftest's ``--xla_cpu_max_isa=AVX2`` matters: with
AVX-512, XLA's float32 results move by 5e-4 of a first step's update.
EMA.ALPHA is 0.9 (the published 0.9996 would move the teacher below the
tolerance) and TEACHER.THRESHOLD 0.1, so that the random teacher gives
pseudo-labels.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.engine.distill import gate_hard_losses as jax_gate_hard_losses
from aldi_tpu.engine.train_step import TrainState as JaxTrainState
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.distill import gate_hard_losses
from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                          make_serving_fn, save_artifact)
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.engine.trainer import ALDITrainer
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.solver import build_lr_schedule, build_optimizer, set_lr
from aldi_tpu_torch.tools import train_net
from aldi_tpu_torch.utils import events
from tests import torch_port_draws as draws_from
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_common import (drop_weight_files, loader_cfg, max_err,
                                     register_synthetic_both, yolo_cfg,
                                     yolo_variables)

def step_cfg(get_cfg, **overrides):
    return yolo_cfg(get_cfg, **{"EMA.ALPHA": 0.9,
                                "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.1,
                                **overrides})


def make_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 8, 4), np.float32)
    classes = np.zeros((b, 8), np.int32)
    valid = np.zeros((b, 8), bool)
    for i in range(b):
        for g in range(3 + i):
            x0, y0 = rng.uniform(0, 70, 2)
            w, h = rng.uniform(12, 56, 2)
            boxes[i, g] = [x0, y0, x0 + w, y0 + h]
            classes[i, g] = rng.integers(0, 3)
            valid[i, g] = True
    return {
        "labeled": {
            "image": rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32),
            "sizes": np.array([[128, 128], [112, 120]], np.int32)[:b],
            "boxes": boxes, "classes": classes, "valid": valid},
        "unlabeled": {
            "image": rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32),
            "sizes": np.array([[128, 128], [120, 100]], np.int32)[:b]},
    }


def _tree(tree, leaf):
    if isinstance(tree, dict):
        return {k: _tree(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def step_draws(rng, cfg, n):
    """The strong views' draws of ``make_train_step(...)(state, batch,
    rng)``: YOLO's step draws nothing else."""
    keys = jax.random.split(rng, 10)
    aug = cfg.AUG
    canvas = tuple(cfg.TPU.CANVAS)
    return {
        "aug_labeled": draws_from.strong_aug_draws(
            keys[1], n, canvas, aug.LABELED_INCLUDE_RANDOM_ERASING,
            aug.LABELED_MIC_AUG, aug.MIC_BLOCK_SIZE),
        "aug_unlabeled": draws_from.strong_aug_draws(
            keys[2], n, canvas, aug.UNLABELED_INCLUDE_RANDOM_ERASING,
            aug.UNLABELED_MIC_AUG, aug.MIC_BLOCK_SIZE)}


def jax_steps(cfg, variables, batches, rngs):
    """The JAX package's jitted step from ``variables``: per step the
    metrics and the state's student and teacher as port state dicts."""
    jdet = jax_build_detector(cfg)
    params = _tree(variables["params"], jnp.asarray)
    tx = jax_build_optimizer(cfg, params)
    stats = {"batch_stats": _tree(variables["batch_stats"], jnp.asarray)}
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params, frozen={},
        opt_state=tx.init(params),
        ema_params=_tree(variables["params"], jnp.asarray),
        model_state=stats,
        ema_model_state={"batch_stats": _tree(variables["batch_stats"],
                                              jnp.asarray)})
    step = jax_make_train_step(cfg, jdet, tx)
    out = []
    for batch, rng in zip(batches, rngs):
        state, m = step(state, _tree(batch, jnp.asarray), rng)
        out.append(({k: float(v) for k, v in m.items()},
                    jax_variables_to_state_dict(_np({
                        "params": state.params, **state.model_state})),
                    jax_variables_to_state_dict(_np({
                        "params": state.ema_params,
                        **state.ema_model_state}))))
    return out


def port_steps(cfg, variables, batches, rngs):
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det,
                               jax_variables_to_state_dict(variables))
    step = make_train_step(cfg, det)
    out = []
    for batch, rng in zip(batches, rngs):
        state, m = step(state, _tree(batch, torch.from_numpy),
                        step_draws(rng, cfg, 2))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in state.student.state_dict(
                    ).items()},
                    {k: v.clone() for k, v in state.teacher.state_dict(
                    ).items()}))
    return out, state


def two_steps(**overrides):
    """Two steps of both packages on the same weights, batches and draws:
    (JAX's, the port's) per step (metrics, student, teacher), and the
    port's final state."""
    jcfg = step_cfg(jax_get_cfg, **overrides)
    tcfg = step_cfg(port_get_cfg, **overrides)
    variables = _np(yolo_variables(jax_build_detector(jcfg), seed=5))
    batches = [make_batch(seed=s) for s in (0, 1)]
    rngs = [jax.random.PRNGKey(s) for s in (41, 42)]
    want = jax_steps(jcfg, variables, batches, rngs)
    got, state = port_steps(tcfg, variables, batches, rngs)
    return want, got, state


def scaled_err(got, want):
    want = want.numpy().astype(np.float64)
    return max_err(got.numpy(), want) / max(float(np.abs(want).max()), 1e-12)


def check_two_steps(want, got, state):
    """Per step: the losses, then the student's and the teacher's
    parameters and BatchNorm running statistics."""
    buffers = {k for k, _ in state.student.named_buffers()}
    for i, ((wm, ws, wt), (gm, gs, gt)) in enumerate(zip(want, got)):
        assert set(gm) == set(wm), sorted(set(gm) ^ set(wm))
        for k, w in wm.items():
            err = abs(gm[k] - w) / max(abs(w), 1e-3)
            print(f"step {i + 1} {k}: {gm[k]:.6g} vs {w:.6g}")
            assert err <= 1e-4, k
        assert wm["num_pseudo_labels"] > 0
        for who, g, w in (("student", gs, ws), ("teacher", gt, wt)):
            assert set(g) == set(w)
            for kind in ("parameters", "running statistics"):
                names = [k for k in w if (k in buffers) ==
                         (kind != "parameters")]
                worst = max(scaled_err(g[k], w[k]) for k in names)
                print(f"step {i + 1} {who} {kind}: worst max err / scale "
                      f"{worst:.3g}")
                second = i == 1 and who == "student" and kind == "parameters"
                assert worst <= (5e-4 if second else 1e-4), (who, kind)
    # the steps moved what they should: the student's statistics, and the
    # teacher's, blended from them after the first step
    (_, s1, t1), (_, s2, t2) = got
    name = "b0.bn.running_var"
    assert not torch.equal(s1[name], s2[name])
    assert not torch.equal(t1[name], t2[name])


def test_two_daod_steps_match_jax():
    """The published recipe: one backward per stream."""
    check_two_steps(*two_steps())


def test_backward_at_end_keeps_the_statistics_order():
    """The port's step with one backward per stream and with one at the
    end runs the streams' forwards in the same order: the running
    statistics come out bitwise equal, the parameters within float32
    rounding of the gradients' sums."""
    variables = _np(yolo_variables(jax_build_detector(
        step_cfg(jax_get_cfg)), seed=5))
    batches = [make_batch(seed=0)]
    rngs = [jax.random.PRNGKey(41)]
    out = {}
    for at_end in (False, True):
        cfg = step_cfg(port_get_cfg, **{"SOLVER.BACKWARD_AT_END": at_end})
        out[at_end] = port_steps(cfg, variables, batches, rngs)[0][0]
    (m0, s0, t0), (m1, s1, t1) = out[False], out[True]
    for k, v in s0.items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, s1[k]), k
        else:
            assert max_err(v.numpy(), s1[k].numpy()) <= 1e-6, k
    for k, v in m0.items():
        assert abs(v - m1[k]) <= 1e-6 * max(abs(v), 1.0), k


@pytest.mark.parametrize("flags", [(False, False, False), (True, True, True),
                                   (True, False, True), (False, True,
                                                         False)])
def test_hard_loss_gating_matches_jax(flags):
    """YOLO's standard losses on pseudo-labels under the HARD_* flags:
    ``loss_obj`` by HARD_OBJ_ENABLED, ``loss_box`` by HARD_ROIH_REG_ENABLED,
    ``loss_cls`` by HARD_ROIH_CLS_ENABLED, as in the JAX package."""
    keys = ("HARD_OBJ_ENABLED", "HARD_ROIH_REG_ENABLED",
            "HARD_ROIH_CLS_ENABLED")
    over = {f"DOMAIN_ADAPT.DISTILL.{k}": v for k, v in zip(keys, flags)}
    losses = {"loss_obj": 2.0, "loss_box": 3.0, "loss_cls": 5.0,
              "loss_da_img": 7.0}
    want = jax_gate_hard_losses(
        {k: jnp.asarray(v) for k, v in losses.items()},
        yolo_cfg(jax_get_cfg, **over))
    got = gate_hard_losses({k: torch.tensor(v) for k, v in losses.items()},
                           yolo_cfg(port_get_cfg, **over))
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in want.items()}
    assert float(got["loss_obj"]) == (2.0 if flags[0] else 0.0)
    assert float(got["loss_box"]) == (3.0 if flags[1] else 0.0)


def test_nesterov_sgd_and_warmup_cosine_match_optax():
    """The published solver (``configs/Base-Yolo.yaml``: SGD with Nesterov
    momentum 0.9, WEIGHT_DECAY 1e-4 on every parameter, BatchNorm's
    included, as the JAX package ignores WEIGHT_DECAY_NORM;
    WarmupCosineLR with WARMUP_ITERS 2500 over 50000 iterations) on the
    tiny YOLO's parameters: the schedule at points of the warmup and the
    cosine, then two steps at the rates of iterations 0 and 1 against
    optax's. float32, rtol 1e-5 (atol 1e-7 for the entries near 0)."""
    jcfg, tcfg = yolo_cfg(jax_get_cfg), yolo_cfg(port_get_cfg)
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.WARMUP_ITERS = 2500
    assert tcfg.SOLVER.NESTEROV and tcfg.SOLVER.WEIGHT_DECAY_NORM == 0.0
    want_lr, got_lr = jax_build_lr_schedule(jcfg), build_lr_schedule(tcfg)
    for count in (0, 1, 1249, 2499, 2500, 2501, 25000, 49999, 50000):
        # JAX's schedule runs in float32: at the cosine's end it rounds a
        # rate of 3e-11 to 0
        np.testing.assert_allclose(got_lr(count), float(want_lr(count)),
                                   rtol=1e-6, atol=1e-10, err_msg=str(count))
    variables = _np(yolo_variables(jax_build_detector(jcfg), seed=2))
    params = _tree(variables["params"], jnp.asarray)
    rng = np.random.default_rng(4)
    grads = [jax.tree_util.tree_map(lambda p: (rng.standard_normal(
        p.shape) * 0.1).astype(np.float32), variables["params"])
        for _ in range(2)]
    tx = jax_build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(_tree(g, jnp.asarray), opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
    want = jax_variables_to_state_dict({"params": _np(params)})

    module = build_detector(tcfg, device="cpu").module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    opt = build_optimizer(tcfg, module)
    named = dict(module.named_parameters())
    for step, g in enumerate(grads):
        for k, v in jax_variables_to_state_dict({"params": g}).items():
            named[k].grad = v
        set_lr(opt, got_lr(step))
        opt.step()
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


# --------------------------------------------------- trainer and artifact
@pytest.fixture
def no_tensorboard(monkeypatch):
    """The writers without TensorBoard: its first event write imports
    TensorFlow here, about 20 s."""
    def unavailable(*args):
        raise ImportError("TensorBoard left out of the tests")

    monkeypatch.setattr(events, "TensorBoardWriter", unavailable)


def trainer_opts(names, out, max_iter, **overrides):
    """``train_net`` overrides: the tiny ALDI-Yolo recipe on the synthetic
    datasets, 2 + 2 images per step, a checkpoint every 2 iterations."""
    cfg = loader_cfg(step_cfg(port_get_cfg), names)
    over = {
        "MODEL.DEVICE": "cpu", "MODEL.WEIGHTS": "", "OUTPUT_DIR": str(out),
        "MODEL.YAML": cfg.MODEL.YAML, "MODEL.YOLO.NUM_CLASSES": 3,
        "TPU.CANVAS": (128, 128), "TPU.MAX_GT": 8,
        "TPU.COMPUTE_DTYPE": "float32", "TPU.DATA_THREADS": 2,
        "INPUT.MIN_SIZE_TRAIN": cfg.INPUT.MIN_SIZE_TRAIN,
        "INPUT.MAX_SIZE_TRAIN": cfg.INPUT.MAX_SIZE_TRAIN,
        "INPUT.MIN_SIZE_TEST": cfg.INPUT.MIN_SIZE_TEST,
        "INPUT.MAX_SIZE_TEST": cfg.INPUT.MAX_SIZE_TEST,
        "DATASETS.TRAIN": cfg.DATASETS.TRAIN,
        "DATASETS.UNLABELED": cfg.DATASETS.UNLABELED,
        "DATASETS.TEST": cfg.DATASETS.TEST,
        "SOLVER.IMS_PER_BATCH": 4, "SOLVER.MAX_ITER": max_iter,
        "SOLVER.CHECKPOINT_PERIOD": 2, "SOLVER.WARMUP_ITERS": 0,
        "TEST.EVAL_PERIOD": 0, "TEST.DETECTIONS_PER_IMAGE": 10,
        "VIS_PERIOD": 0, "SEED": 7, "EMA.ALPHA": 0.9,
        # a rate that does not depend on MAX_ITER (the cosine's does), so
        # that 2 iterations, then 2 more, see the rates of 4 straight
        "SOLVER.LR_SCHEDULER_NAME": "WarmupMultiStepLR",
        "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.1, **overrides}
    return [x for k, v in over.items() for x in (k, str(v))]


def _stats(module):
    return {k: v.clone() for k, v in module.named_buffers()}


def test_train_net_saves_resumes_and_restores_the_ema_statistics(
        tmp_path, no_tensorboard):
    """``train_net`` on the ALDI-Yolo YAML: 2 iterations with a
    checkpoint, whose ``ema`` entry holds the teacher's running statistics;
    ``--resume`` restores them exactly and goes on to 4, where student and
    teacher equal those of 4 straight iterations bit for bit. The eval at
    4 runs the teacher in eval mode: its statistics do not move."""
    names = register_synthetic_both(tmp_path / "data", "port_yolo_trainer")
    config = "configs/cityscapes/ALDI-Yolo-Cityscapes.yaml"
    parser = train_net.default_argument_parser()
    try:
        broken = tmp_path / "broken"
        train_net.main(parser.parse_args(
            ["--config-file", config] + trainer_opts(names, broken, 2)))
        ckpt = torch.load(broken / "model_0000002.pth", weights_only=True)
        saved = {k[len("model."):]: v for k, v in ckpt["ema"].items()
                 if k.endswith(("running_mean", "running_var"))}
        assert len(saved) == 2 * 57  # the yolov5n's BatchNorms
        assert any(not torch.equal(v, ckpt["model"][k])
                   for k, v in saved.items())

        args = parser.parse_args(["--config-file", config, "--resume"]
                                 + trainer_opts(names, broken, 4))
        trainer = ALDITrainer(train_net.setup(args))
        trainer.resume_or_load(resume=True)
        assert trainer.state.step == 2
        restored = _stats(trainer.state.teacher)
        for k, v in saved.items():
            assert torch.equal(restored[k], v), k
        trainer.train()

        straight = ALDITrainer(train_net.setup(parser.parse_args(
            ["--config-file", config] + trainer_opts(
                names, tmp_path / "straight", 4,
                **{"TEST.EVAL_PERIOD": 4}))))
        straight.resume_or_load(resume=False)
        results = straight.train()
        for a, b in ((trainer.state.student, straight.state.student),
                     (trainer.state.teacher, straight.state.teacher)):
            for (k, v), w in zip(a.state_dict().items(),
                                 b.state_dict().values()):
                assert torch.equal(v, w), k
        ap = results[names["val"]]["bbox/AP50"]
        print(f"AP50 of the teacher after 4 iterations: {ap}")
        assert np.isfinite(ap)
        teacher = _stats(straight.state.teacher)
        straight.test()
        for k, v in _stats(straight.state.teacher).items():
            assert torch.equal(v, teacher[k]), k
        assert not straight.state.teacher.training
        with open(broken / "metrics.json") as f:
            lines = [json.loads(x) for x in f]
        assert "loss_soft_obj_distill" in lines[-1]
    finally:
        drop_weight_files(tmp_path)


def test_artifact_round_trip_is_bitwise_eager(tmp_path):
    """A tiny YOLO after one training step (running statistics away from
    their initial values) exported for the CPU, saved and loaded: the
    program serves bitwise what the eager path does, reads its statistics
    as constants (no buffer is mutated by the graph), and
    ``meta.json`` names the architecture."""
    cfg = step_cfg(port_get_cfg)
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det)
    batch = _tree(make_batch(seed=3), torch.from_numpy)
    make_train_step(cfg, det)(state, batch, draw_step(
        torch.Generator().manual_seed(0), det, 2, 2))
    stats = _stats(det.module)
    assert not torch.equal(stats["b0.bn.running_mean"],
                           torch.zeros_like(stats["b0.bn.running_mean"]))
    programs = export_inference(det, None, 2, platforms=("cpu",))
    assert not programs["cpu"].graph_signature.buffers_to_mutate
    save_artifact(str(tmp_path), programs, det, cfg, 2)
    model = load_artifact(str(tmp_path), platform="cpu")
    assert model.meta["meta_architecture"] == "Yolo"
    images = batch["unlabeled"]["image"]
    sizes = batch["unlabeled"]["sizes"]
    got = model(images, sizes)
    want = make_serving_fn(det)(images, sizes)
    assert int(want["valid"].sum()) > 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k, v in _stats(det.module).items():
        assert torch.equal(v, stats[k]), k
    assert not det.module.training
    os.remove(os.path.join(tmp_path, "serving.cpu.pt2"))
