"""Port parity of the ConvNeXt backbone and the ConvNeXt Faster R-CNN
(``aldi_tpu_torch/models/convnext.py``; ``configs/cityscapes/
ALDI-Best-ConvNeXt-Cityscapes.yaml``) against the JAX package, on the CPU,
in float32, at a tiny width: depths (1, 1, 2, 1), dims (8, 16, 32, 64),
canvas 64 (the trunk) or 128 (the detector), 3 classes, the published
anchors (64-1024 px) and recipe (AdamW, ALDI++ with EMA and soft
distillation), drop path 0.5 so that some keep flag is 0.

``gamma`` (the layer scale) and the LayerNorms' affine are random O(1)
values: at the JAX package's initial ``gamma`` of 1e-6 every block is the
identity to six digits, and a wrong depthwise conv or MLP would pass. The
drop-path masks are captured from the JAX backbone
(``tests/torch_port_draws.convnext_drop_masks``). The JAX trunk runs
un-jitted; the JAX detector's passes, the optax updates and the whole
DAOD step run jitted, as in ``tests/test_torch_port_train_step.py`` (un-
jitted, the detector's gradient alone takes a minute here).

Tolerances: trunk outputs 1e-5 of each output's largest magnitude and
detections as in ``test_torch_port_models.py`` (boxes 1e-3 px, scores
1e-5): float32 convolutions and matrix products sum in another order in
each framework. Losses 1e-4 relative, gradients 1e-4 of each tensor's
largest magnitude. After one AdamW step (~ lr * sign(g)) 99% of the
entries within 1e-5 and all within 2.5 x lr, as
``test_torch_port_vit_train.py`` holds them; the reference oracle
(pure torch, same arithmetic order) 1e-5 of each output's scale.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models.convnext import ConvNeXt as JaxConvNeXt
from aldi_tpu.models.convnext import ConvNeXtBlock as JaxConvNeXtBlock
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu.structures import Instances as JaxInstances
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import (
    jax_variables_to_state_dict, reference_state_dict_to_port)
from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                          make_serving_fn, save_artifact)
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models.convnext import ConvNeXt, ConvNeXtBlock
from aldi_tpu_torch.solver import build_lr_schedule, build_optimizer, set_lr
from aldi_tpu_torch.structures import Instances
from aldi_tpu_torch.utils import events
from tests import torch_port_draws as draws_from
from tests.test_torch_port_train_step import (close_rel, jax_tree, make_batch,
                                              torch_tree)
from tests.torch_convnext_oracle import (build_convnext, convnext_forward,
                                         golden_d2_convnext_names)
from tests.torch_port_common import (drop_weight_files, loader_cfg, max_err,
                                     register_synthetic_both,
                                     seeded_variables, teacher_ctx_from_jax,
                                     tiny_images)
from tests.torch_rcnn_oracle import randomize
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

CONVNEXT_ALDI = "configs/cityscapes/ALDI-Best-ConvNeXt-Cityscapes.yaml"
DEPTHS, DIMS = (1, 1, 2, 1), (8, 16, 32, 64)
DROP = 0.5
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def convnext_cfg(get_cfg, saturated=False):
    cfg = get_cfg()
    cfg.merge_from_file(CONVNEXT_ALDI)
    c = cfg.MODEL.CONVNEXT
    c.DEPTHS, c.DIMS, c.DROP_PATH_RATE = list(DEPTHS), list(DIMS), DROP
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN, rpn.POST_NMS_TOPK_TRAIN = 64, 32
    rpn.PRE_NMS_TOPK_TEST, rpn.POST_NMS_TOPK_TEST = 64, 32
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.3
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.WARMUP_ITERS = 0
    if saturated:  # see tests/test_torch_port_train_step.py daod_cfg
        rpn.BATCH_SIZE_PER_IMAGE = 4096
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 40
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    return cfg


def fill_gammas(tree, rng):
    """Every ``gamma`` leaf of a flax params tree set to uniform(0.5, 1.5)
    (in place)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            fill_gammas(v, rng)
        elif k == "gamma":
            tree[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
    return tree


def convnext_variables(jdet, seed):
    """``seeded_variables`` (LayerNorm scales uniform(0.5, 1.5)) with O(1)
    ``gamma``s and the class logits at a third of their spread (see
    ``tests/test_torch_port_vit_train.py`` ``vit_variables``)."""
    variables = seeded_variables(jdet, seed)
    fill_gammas(variables["params"], np.random.default_rng(seed + 100))
    cls = variables["params"]["box_predictor"]["cls_score"]
    cls["kernel"] = cls["kernel"] / 3
    return variables


def seeded_tree(shapes, seed):
    """A flax params tree of ``shapes`` filled from a numpy seed: kernels
    with std 1/sqrt(fan_in), LayerNorm scales and ``gamma`` uniform(0.5,
    1.5), biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = getattr(path[-1], "key", str(path[-1]))
        if leaf == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if leaf in ("scale", "gamma"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def recorded_masks(apply):
    """Run ``apply()`` with ``jax.random.bernoulli`` recording each mask;
    returns (its output, the masks flattened, in call order)."""
    recorded, real = [], jax.random.bernoulli

    def bernoulli(key, p, shape):
        mask = real(key, p, shape)
        recorded.append(np.asarray(mask).reshape(-1))
        return mask

    jax.random.bernoulli = bernoulli
    try:
        return apply(), recorded
    finally:
        jax.random.bernoulli = real


def rel_err(got, want):
    want = np.asarray(want)
    return max_err(got, want) / max(float(np.abs(want).max()), 1e-6)


# --------------------------------------------------------------- trunk
@pytest.mark.parametrize("drop", [False, True])
def test_block_matches_jax(drop):
    """One block (dim 16, drop path 0.5), without and with a keep mask."""
    x = np.random.default_rng(1).standard_normal((4, 9, 11, 16)).astype(
        np.float32)
    jblock = JaxConvNeXtBlock(dim=16, drop_path=DROP)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = seeded_tree(dict(shapes), seed=2)
    key = jax.random.PRNGKey(5)
    want, masks = recorded_masks(lambda: jblock.apply(
        {"params": params}, jnp.asarray(x), drop,
        rngs={"dropout": key} if drop else None))
    block = ConvNeXtBlock(16, DROP)
    prefix = "backbone.bottom_up.stages.0.0."
    sd = jax_variables_to_state_dict(
        {"params": {"backbone": {"stage0_block0": params}}})
    block.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    keep = torch.from_numpy(masks[0]) if drop else None
    if drop:
        assert not masks[0].all() and masks[0].any()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = block(xt, keep).permute(0, 2, 3, 1).numpy()
    err = rel_err(got, want)
    print(f"block (drop {drop}): max abs err / scale {err:.3g} (tol 1e-5)")
    assert err <= 1e-5


@pytest.mark.parametrize("train", [False, True])
def test_backbone_matches_jax(train):
    """The whole trunk, res2..res5, in inference and in training mode with
    the keep masks JAX draws (one per block of a non-zero rate)."""
    x = np.random.default_rng(3).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jnet = JaxConvNeXt(depths=DEPTHS, dims=DIMS, drop_path_rate=DROP)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = seeded_tree(dict(shapes), seed=4)
    want, masks = recorded_masks(lambda: jnet.apply(
        {"params": params}, jnp.asarray(x), train,
        rngs={"dropout": jax.random.PRNGKey(6)} if train else None))
    net = ConvNeXt(DEPTHS, DIMS, DROP)
    prefix = "backbone.bottom_up."
    sd = jax_variables_to_state_dict({"params": {"backbone": params}})
    net.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    drop = None
    if train:
        drop = torch.ones((sum(DEPTHS), 2), dtype=torch.bool)
        drop[1:] = torch.from_numpy(np.stack(masks))  # block 0: rate 0
        assert not drop.all()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = net(xt, drop)
    for lvl, w in want.items():
        err = rel_err(got[lvl].permute(0, 2, 3, 1).numpy(), w)
        print(f"{lvl} (train {train}): max abs err / scale {err:.3g} "
              f"(tol 1e-5)")
        assert err <= 1e-5, lvl
        assert got[lvl].is_contiguous(memory_format=torch.channels_last)


def test_reference_convnext_names_and_forward():
    """A reference ConvNeXt state dict (``tests/torch_convnext_oracle.py``,
    its ``gamma``s set to O(1)) through ``reference_state_dict_to_port``:
    the port's trunk carries the oracle's golden names and computes its
    ``convnext_forward``."""
    root = randomize(build_convnext(DEPTHS, DIMS), seed=13)
    g = torch.Generator().manual_seed(14)
    with torch.no_grad():
        for name, p in root.named_parameters():
            if name.endswith("gamma"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
    det = build_detector(convnext_cfg(port_get_cfg), device="cpu")
    target = det.module.state_dict()
    trunk = {k for k in target if k.startswith("backbone.bottom_up.")}
    assert trunk == golden_d2_convnext_names(DEPTHS)
    det.module.load_state_dict(reference_state_dict_to_port(
        root.state_dict(), target))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    want = convnext_forward(root, x)
    with torch.no_grad():
        got = det.module.backbone.bottom_up(
            x.contiguous(memory_format=torch.channels_last))
    for lvl in want:
        err = rel_err(got[lvl].numpy(), want[lvl].numpy())
        print(f"{lvl}: oracle max abs err / scale {err:.3g} (tol 1e-5)")
        assert err <= 1e-5, lvl


def test_jax_variables_convert_every_convnext_leaf():
    """Every leaf of the JAX ConvNeXt detector has one port tensor with its
    values, and the port has no other."""
    jdet = jax_build_detector(convnext_cfg(jax_get_cfg))
    variables = convnext_variables(jdet, seed=0)
    sd = jax_variables_to_state_dict(variables)
    det = build_detector(convnext_cfg(port_get_cfg), device="cpu")
    assert set(sd) == set(det.module.state_dict())
    leaves = jax.tree_util.tree_leaves(dict(variables))
    assert len(leaves) == len(sd)
    block = variables["params"]["backbone"]["stage2_block1"]
    dw = block["dwconv"]["kernel"]  # [7, 7, 1, C]
    assert np.array_equal(
        sd["backbone.bottom_up.stages.2.1.dwconv.weight"].numpy(),
        np.transpose(dw, (3, 2, 0, 1)))
    assert np.array_equal(sd["backbone.bottom_up.stages.2.1.gamma"].numpy(),
                          block["gamma"])
    assert np.array_equal(
        sd["backbone.bottom_up.downsample_layers.0.1.weight"].numpy(),
        variables["params"]["backbone"]["downsample0_norm"]["scale"])
    assert np.array_equal(
        sd["backbone.bottom_up.downsample_layers.3.0.weight"].numpy(),
        variables["params"]["backbone"]["downsample3_norm"]["scale"])


# ------------------------------------------------------------ detector
@pytest.fixture(scope="module")
def dets():
    jdet = jax_build_detector(convnext_cfg(jax_get_cfg))
    variables = convnext_variables(jdet, seed=3)
    tdet = build_detector(convnext_cfg(port_get_cfg), device="cpu")
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    return jdet, variables, tdet


def test_forward_inference_matches_jax(dets):
    jdet, variables, tdet = dets
    images, sizes = tiny_images(2)
    want = [np.asarray(a) for a in jax.jit(jdet.forward_inference)(
        jax_tree(dict(variables)), jnp.asarray(images), jnp.asarray(sizes))]
    got = [a.numpy() for a in tdet.forward_inference(
        torch.from_numpy(images), torch.from_numpy(sizes))]
    m = want[3]
    assert np.array_equal(got[3], m) and m.sum() > 0
    assert np.array_equal(got[2][m], want[2][m])
    box_err, score_err = max_err(got[0][m], want[0][m]), max_err(
        got[1][m], want[1][m])
    print(f"{int(m.sum())} detections: boxes max abs err {box_err:.3g} "
          f"(tol 1e-3), scores {score_err:.3g} (tol 1e-5)")
    assert box_err <= 1e-3 and score_err <= 1e-5


def test_forward_train_with_drop_path_matches_jax(dets):
    """``forward_train`` with the drop-path masks JAX draws: losses and
    every gradient, nothing frozen (FREEZE_AT 2 freezes only ResNet
    names)."""
    jdet, variables, tdet = dets
    batch = make_batch()
    lab = batch["labeled"]
    rng = jax.random.PRNGKey(21)
    gt = JaxInstances(*(jnp.asarray(lab[k]) for k in (
        "boxes", "classes", "valid")))

    def loss_fn(params):
        losses, _ = jdet.forward_train({"params": params},
                                       jnp.asarray(lab["image"]),
                                       jnp.asarray(lab["sizes"]), gt, rng)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_tree(dict(variables["params"])))
    draws = draws_from.forward_train_draws(
        rng, tdet.cfg, 2, tdet.anchors_cat.shape[0],
        functools.partial(draws_from.convnext_drop_masks, jdet, variables))
    assert draws["drop"].shape == (sum(DEPTHS), 2)
    assert not draws["drop"].all()
    tb = torch_tree(batch)
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    tdet.module.zero_grad(set_to_none=True)
    losses, _ = tdet.forward_train(
        tdet.module, tb["labeled"]["image"], tb["labeled"]["sizes"],
        Instances(tb["labeled"]["boxes"], tb["labeled"]["classes"],
                  tb["labeled"]["valid"]), draws)
    assert set(losses) == set(want)
    for k in want:
        close_rel(losses[k], want[k], what=k)
    sum(losses.values()).backward()
    want_g = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    params = dict(tdet.module.named_parameters())
    assert all(p.requires_grad for p in params.values())
    worst = max(rel_err(params[k].grad.numpy(), w.numpy())
                for k, w in want_g.items())
    print(f"gradients: worst max abs err / tensor scale {worst:.3g} "
          f"(tol 1e-4)")
    assert worst <= 1e-4


def test_draw_step_draws_convnext_masks(dets):
    _, _, tdet = dets
    a = draw_step(torch.Generator().manual_seed(3), tdet, 2, 2)
    b = draw_step(torch.Generator().manual_seed(3), tdet, 2, 2)
    for stream in ("strong", "distill"):
        m = a[stream]["drop"]
        assert m.shape == (sum(DEPTHS), 2) and m.dtype == torch.bool
        assert m[0].all()  # block 0 has rate 0
        assert torch.equal(m, b[stream]["drop"])
    assert "drop" not in a["teacher"]


def test_adamw_matches_optax(dets):
    """Three AdamW updates with the same gradients: weight decay on every
    ConvNeXt parameter (``gamma`` and the LayerNorms included), no layer
    decay, the same learning rate for every group."""
    jdet, variables, tdet = dets
    jcfg, tcfg = convnext_cfg(jax_get_cfg), convnext_cfg(port_get_cfg)
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.WARMUP_ITERS = 2
        cfg.SOLVER.WEIGHT_DECAY = 0.5
    params = jax_tree(dict(variables["params"]))
    tx = jax_build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    module = tdet.module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    opt = build_optimizer(tcfg, module)
    assert [(g["lr_mult"], g["weight_decay"]) for g in opt.param_groups] \
        == [(1.0, 0.5)]
    schedule = build_lr_schedule(tcfg)
    rng = np.random.default_rng(0)
    named = dict(module.named_parameters())
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(
                np.float32), params)
        updates, opt_state = update(jax_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in jax_variables_to_state_dict({"params": grads}).items():
            named[name].grad = g
        set_lr(opt, schedule(step))
        opt.step()
    want = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params)})
    err = max(max_err(named[k].detach().numpy(), w.numpy())
              for k, w in want.items())
    print(f"AdamW, 3 updates: max abs err {err:.3g} (tol 1e-6)")
    assert err <= 1e-6


def test_daod_step_matches_jax():
    """One ALDI++ DAOD step of the ConvNeXt recipe (AdamW, EMA, soft
    distillation, drop path) in both packages on the same draws: every
    loss, and the student's parameters after the step. The port's teacher
    pass is held to the JAX package's pseudo-labels and then goes on from
    the JAX package's context (``teacher_ctx_from_jax``: 64-1024 px anchors
    over the tiny canvas's small pseudo-labels tie often)."""
    jcfg = convnext_cfg(jax_get_cfg, saturated=True)
    tcfg = convnext_cfg(port_get_cfg, saturated=True)
    jdet = jax_build_detector(jcfg)
    variables = convnext_variables(jdet, seed=11)
    batch = make_batch(seed=2)
    rng = jax.random.PRNGKey(41)
    state, tx = jax_create_train_state(jcfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params, opt_state=tx.init(params),
                          ema_params=jax_tree(dict(variables["params"])))
    state, m = jax_make_train_step(jcfg, jdet, tx)(state, jax_tree(batch),
                                                  rng)
    want_m = {k: float(v) for k, v in m.items()}
    want = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, state.params)})

    det = build_detector(tcfg, device="cpu")
    draws = draws_from.train_step_draws(
        rng, tcfg, 2, 2, det.anchors_cat.shape[0],
        functools.partial(draws_from.convnext_drop_masks, jdet, variables))
    assert not draws["strong"]["drop"].all()
    start = jax_variables_to_state_dict(variables)
    pstate = create_train_state(tcfg, det, start)
    uw = batch["unlabeled"]
    with teacher_ctx_from_jax(det, jdet, variables, uw["image"], uw["sizes"],
                              jax.random.split(rng, 10)[0]):
        pstate, got = make_train_step(tcfg, det)(pstate, torch_tree(batch),
                                                 draws)
    got_m = {k: float(v) for k, v in got.items()}
    assert set(got_m) == set(want_m), set(got_m) ^ set(want_m)
    for k in want_m:
        close_rel(got_m[k], want_m[k], what=k)
    assert want_m["num_pseudo_labels"] > 0
    got_p = dict(pstate.student.named_parameters())
    diffs = [(got_p[k].detach() - w).abs() for k, w in want.items()]
    err = max(float(d.max()) for d in diffs)
    beyond = sum(int((d > 1e-5).sum()) for d in diffs)
    total = sum(d.numel() for d in diffs)
    moved = sum(not torch.equal(got_p[k].detach(), start[k]) for k in want)
    print(f"after one AdamW step: max abs err {err:.3g}, {beyond} of {total} "
          f"entries beyond 1e-5 (tol 1%, all within {2.5 * LR:g}); "
          f"{moved} of {len(want)} tensors moved")
    assert beyond <= 0.01 * total and err <= 2.5 * LR
    assert moved == len(want)


# ----------------------------------------------------- user surfaces
def test_export_cpu_equals_eager(dets, tmp_path):
    """The tiny ConvNeXt detector exported for ``cpu``, saved and loaded:
    every output bitwise equal to the eager ``make_serving_fn``."""
    _, _, tdet = dets
    images, sizes = tiny_images(2)
    weights = tdet.module.state_dict()
    eager = make_serving_fn(tdet, weights)(images, sizes)
    programs = export_inference(tdet, None, 2, platforms=("cpu",))
    save_artifact(str(tmp_path), programs, tdet, tdet.cfg, 2)
    served = load_artifact(str(tmp_path), platform="cpu")(images, sizes)
    assert eager["valid"].any()
    for k in eager:
        assert torch.equal(served[k], eager[k]), k
    drop_weight_files(tmp_path)


def test_build_detector_takes_the_published_config():
    """The ConvNeXt-L YAML as published but for depth (1 block per stage)
    and the canvas: widths 192-1536, no parameter frozen, AdamW with weight
    decay 0.05 on all of them."""
    cfg = port_get_cfg()
    cfg.merge_from_file(CONVNEXT_ALDI)
    cfg.MODEL.CONVNEXT.DEPTHS = [1, 1, 1, 1]
    cfg.TPU.CANVAS = (128, 128)
    det = build_detector(cfg, device="cpu")
    sd = det.module.state_dict()
    assert sd["backbone.bottom_up.stages.3.0.pwconv1.weight"].shape == (
        6144, 1536)
    assert sd["backbone.fpn_lateral2.weight"].shape == (256, 192, 1, 1)
    assert all(p.requires_grad for p in det.module.parameters())
    opt = create_train_state(cfg, det).optimizer
    assert isinstance(opt, torch.optim.AdamW)
    assert [(g["lr_mult"], g["weight_decay"]) for g in opt.param_groups] \
        == [(1.0, 0.05)]


def test_train_net_runs_two_iterations(tmp_path, monkeypatch):
    """The tiny ConvNeXt recipe through ``tools/train_net.py`` for two
    iterations of 1 + 1 images on synthetic datasets: finite losses in
    ``metrics.json`` and the last iteration's checkpoint."""
    from aldi_tpu_torch.tools import train_net

    def no_tensorboard(*args):  # see tests/test_torch_port_trainer.py
        raise ImportError("TensorBoard left out of the tests")

    monkeypatch.setattr(events, "TensorBoardWriter", no_tensorboard)
    names = register_synthetic_both(
        tmp_path / "data", "port_convnext",
        {"train": (2, 0, False), "val": (2, 1, False),
         "unlabeled": (2, 2, True)})
    cfg = loader_cfg(convnext_cfg(port_get_cfg), names)
    opts = []
    for key, value in (
            ("MODEL.CONVNEXT.DEPTHS", cfg.MODEL.CONVNEXT.DEPTHS),
            ("MODEL.CONVNEXT.DIMS", cfg.MODEL.CONVNEXT.DIMS),
            ("MODEL.ROI_HEADS.NUM_CLASSES", 3), ("TPU.CANVAS", (128, 128)),
            ("TPU.COMPUTE_DTYPE", "float32"), ("TPU.MAX_GT", 8),
            ("TPU.DATA_THREADS", 2),
            ("INPUT.MIN_SIZE_TRAIN", cfg.INPUT.MIN_SIZE_TRAIN),
            ("INPUT.MAX_SIZE_TRAIN", 128), ("INPUT.MIN_SIZE_TEST", 96),
            ("INPUT.MAX_SIZE_TEST", 128),
            ("DATASETS.TRAIN", cfg.DATASETS.TRAIN),
            ("DATASETS.UNLABELED", cfg.DATASETS.UNLABELED),
            ("DATASETS.TEST", cfg.DATASETS.TEST),
            ("SOLVER.IMS_PER_BATCH", 2), ("SOLVER.MAX_ITER", 2),
            ("SOLVER.CHECKPOINT_PERIOD", 0), ("TEST.EVAL_PERIOD", 0),
            ("MODEL.WEIGHTS", ""), ("MODEL.DEVICE", "cpu"),
            ("OUTPUT_DIR", str(tmp_path / "out")), ("VIS_PERIOD", 0)):
        opts += [key, str(value)]
    args = train_net.default_argument_parser().parse_args(
        ["--config-file", CONVNEXT_ALDI] + opts)
    train_net.main(args)
    out = tmp_path / "out"
    with open(out / "metrics.json") as f:
        lines = [json.loads(line) for line in f]
    assert lines and np.isfinite(lines[0]["total_loss"])
    assert "loss_cls_source_strong" in lines[0]
    assert os.path.exists(out / "model_0000002.pth")
    drop_weight_files(tmp_path)
