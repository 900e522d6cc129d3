"""Port parity of the ViTDet DAOD training step against the JAX package, on
the CPU, in float32, at the tiny ViTDet (``tests/torch_port_common``) with
drop path 0.5 (so that some keep mask is 0) and the recipe of
``configs/cityscapes/ALDI-Best-ViT-Cityscapes.yaml``: AdamW with the ViT-B
layer decay, activation checkpointing, labeled_strong + distill, EMA, soft
distillation.

The drop-path masks are captured from the JAX backbone
(``tests/torch_port_draws.vit_drop_masks``); every other draw is derived
from the JAX key by the JAX package's own splits.

The box head of the training tests is the FC head (NUM_CONV 0): in the
full step, the gradient of the ViTDet LN conv head's first conv is a sum
that cancels to 1e-3 of its terms, and the JAX package's own jitted and
un-jitted gradients of it differ by 2e-3 of the tensor's scale (the port
equals the un-jitted one on the same inputs to 1e-6). The LN conv head is
held against JAX in ``tests/test_torch_port_vit.py``.

Tolerances: parameters after AdamW updates with identical gradients 1e-6
(a few float32 ulps of parameters up to ~2, summed in another order);
losses 1e-4 relative and gradients 1e-4 of each tensor's largest magnitude
(float32 matrix products and convolutions sum in another order in each
framework); parameters after two full steps as
``test_two_vit_daod_steps_match_jax`` states.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu.structures import Instances as JaxInstances
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.ops.flash_attn_kernel import flash_attn_bwd, flash_attn_fwd
from aldi_tpu_torch.solver import (build_lr_schedule, build_optimizer, set_lr,
                                   vit_lr_decay_multiplier)
from aldi_tpu_torch.structures import Instances
from tests import torch_port_draws as draws_from
from tests.test_torch_port_train_step import (close_rel, jax_tree, make_batch,
                                              torch_tree)
from tests.torch_port_common import max_err, seeded_variables, tiny_vit
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

VIT_ALDI = "configs/cityscapes/ALDI-Best-ViT-Cityscapes.yaml"
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _tiny_vit():
    with tiny_vit(drop_path_rate=0.5):
        yield


def vit_cfg(get_cfg, saturated=False):
    cfg = get_cfg()
    cfg.merge_from_file(VIT_ALDI)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    cfg.MODEL.ROI_BOX_HEAD.NORM = ""
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN, rpn.POST_NMS_TOPK_TRAIN = 64, 32
    rpn.PRE_NMS_TOPK_TEST, rpn.POST_NMS_TOPK_TEST = 64, 32
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.5
    cfg.SOLVER.BASE_LR = LR
    cfg.SOLVER.WARMUP_ITERS = 0
    if saturated:  # see tests/test_torch_port_train_step.py daod_cfg
        rpn.BATCH_SIZE_PER_IMAGE = 4096
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 40
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
        cfg.EMA.ALPHA = 0.9
    return cfg


def vit_variables(jdet, seed):
    """``seeded_variables`` with the class logits at a third of their
    spread: a saturated softmax (p = 1 - 1e-4) leaves float32 noise of 1e-3
    relative in 1 - p, hence in the gradients of loss_cls."""
    variables = seeded_variables(jdet, seed)
    cls = variables["params"]["box_predictor"]["cls_score"]
    cls["kernel"] = cls["kernel"] / 3
    return variables


@pytest.fixture(scope="module")
def dets():
    jcfg, tcfg = vit_cfg(jax_get_cfg), vit_cfg(port_get_cfg)
    jdet = jax_build_detector(jcfg)
    variables = vit_variables(jdet, seed=3)
    tdet = build_detector(tcfg, device="cpu")
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    return jdet, variables, tdet


# ------------------------------------------------------------ optimizer
def test_adamw_with_layer_decay_matches_optax(dets):
    """Three AdamW updates with the same gradients: the layer-decay
    multipliers, the pos_embed mask (no weight decay) and the warm-up."""
    jdet, variables, tdet = dets
    jcfg, tcfg = vit_cfg(jax_get_cfg), vit_cfg(port_get_cfg)
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.WEIGHT_DECAY = 0.5
        cfg.SOLVER.WARMUP_ITERS = 2
    params = jax_tree(dict(variables["params"]))
    tx = jax_build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    module = tdet.module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    opt = build_optimizer(tcfg, module)
    schedule = build_lr_schedule(tcfg)
    assert isinstance(opt, torch.optim.AdamW)
    rng = np.random.default_rng(0)
    named = dict(module.named_parameters())
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(
                np.float32), params)
        updates, opt_state = tx.update(jax_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in jax_variables_to_state_dict({"params": grads}).items():
            named[name].grad = g
        set_lr(opt, schedule(step))
        opt.step()
    want = jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, params)})
    start = jax_variables_to_state_dict(variables)
    err = max(max_err(named[k].detach().numpy(), w.numpy())
              for k, w in want.items())
    pos = "backbone.net.pos_embed"
    print(f"AdamW, 3 updates: max abs err {err:.3g}; pos_embed moved "
          f"{max_err(want[pos].numpy(), start[pos].numpy()):.3g}")
    assert err <= 1e-6
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    assert groups[id(named[pos])]["weight_decay"] == 0.0
    mults = {g["lr_mult"]: g["weight_decay"] for g in opt.param_groups}
    assert 0.7 ** 13 in mults and mults[1.0] == 0.5
    assert vit_lr_decay_multiplier("backbone.net.blocks.2.mlp.fc1.weight") \
        == 0.7 ** 10
    assert vit_lr_decay_multiplier("backbone.simfp_2.0.weight") == 1.0


# -------------------------------------------------------------- forward
def test_forward_train_losses_and_grads_match_jax(dets):
    """``forward_train`` of the tiny ViTDet with drop path on (some masks 0)
    and activation checkpointing, against the JAX package's jitted
    value_and_grad on the same draws."""
    jdet, variables, tdet = dets
    batch = make_batch()
    lab = batch["labeled"]
    rng = jax.random.PRNGKey(21)
    gt = JaxInstances(*(jax.numpy.asarray(lab[k]) for k in (
        "boxes", "classes", "valid")))

    def loss_fn(params):
        losses, _ = jdet.forward_train({"params": params},
                                       jax.numpy.asarray(lab["image"]),
                                       jax.numpy.asarray(lab["sizes"]), gt,
                                       rng)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_tree(dict(variables["params"])))
    draws = draws_from.forward_train_draws(
        rng, tdet.cfg, 2, tdet.anchors_cat.shape[0],
        functools.partial(draws_from.vit_drop_masks, jdet, variables))
    assert not draws["drop"].all()
    tb = torch_tree(batch)
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    tdet.module.zero_grad(set_to_none=True)
    before = flash_attn_fwd.launches, flash_attn_bwd.launches
    losses, _ = tdet.forward_train(
        tdet.module, tb["labeled"]["image"], tb["labeled"]["sizes"],
        Instances(tb["labeled"]["boxes"], tb["labeled"]["classes"],
                  tb["labeled"]["valid"]), draws)
    assert set(losses) == set(want)
    for k in want:
        close_rel(losses[k], want[k], what=k)
    sum(losses.values()).backward()
    assert (flash_attn_fwd.launches, flash_attn_bwd.launches) == before
    want_g = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    params = dict(tdet.module.named_parameters())
    worst = 0.0
    for name, w in want_g.items():
        scale = max(float(w.abs().max()), 1e-6)
        worst = max(worst, max_err(params[name].grad.numpy(), w.numpy())
                    / scale)
    print(f"gradients: worst max abs err / tensor scale {worst:.3g}")
    assert worst <= 1e-4


# ---------------------------------------------------------- whole step
def _jax_steps(cfg, variables, batch, rngs):
    jdet = jax_build_detector(cfg)
    state, tx = jax_create_train_state(cfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params, opt_state=tx.init(params),
                          ema_params=jax_tree(dict(variables["params"])))
    step = jax_make_train_step(cfg, jdet, tx)
    metrics = []
    for rng in rngs:
        state, m = step(state, jax_tree(batch), rng)
        metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (metrics, jax_variables_to_state_dict({"params": to_np(
        state.params)}), jax_variables_to_state_dict({"params": to_np(
            state.ema_params)}))


def _key_bias_mask(name, shape):
    """True on the entries of ``name`` that are the attention's key bias."""
    mask = torch.zeros(shape, dtype=torch.bool)
    if name.endswith("attn.qkv.bias"):
        third = shape[0] // 3
        mask[third:2 * third] = True
    return mask


@pytest.mark.parametrize("optimizer", ["ADAMW", "SGD"])
def test_two_vit_daod_steps_match_jax(optimizer):
    """Two full DAOD steps of both packages (the second blends the EMA
    teacher): per-key losses, and every parameter of student and teacher.

    SGD (learning rate 0.01) is linear in the gradients: every entry is
    held to 1e-6. AdamW's first steps are m / (sqrt(v) + eps) ~ sign(g):
    an entry whose gradient sits at the float32 noise of its tensor (up to
    6% of the entries of the pyramid's p4/p5 convs, whose gradients are
    small sums at canvas 128) moves by up to the learning rate either way
    in each framework. So with AdamW at least 99% of the model's entries
    are held to 1e-5 and all to 4 x LR (two steps of at most about LR
    each, in opposite directions on the two sides);
    the key bias (a zero gradient in exact arithmetic) is held to that
    bound only. The losses of the second step, which see every entry's
    first update, are held to 1e-4 relative in both cases."""
    adamw = optimizer == "ADAMW"
    jcfg, tcfg = vit_cfg(jax_get_cfg, True), vit_cfg(port_get_cfg, True)
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.OPTIMIZER = optimizer
        cfg.SOLVER.BASE_LR = LR if adamw else 0.01
    jdet = jax_build_detector(jcfg)
    variables = vit_variables(jdet, seed=11)
    batch = make_batch(seed=2)
    rngs = [jax.random.PRNGKey(41), jax.random.PRNGKey(42)]
    det = build_detector(tcfg, device="cpu")
    drop = functools.partial(draws_from.vit_drop_masks, jdet, variables)
    draws = [draws_from.train_step_draws(r, tcfg, 2, 2,
                                         det.anchors_cat.shape[0], drop)
             for r in rngs]
    assert not all(bool(d["strong"]["drop"].all()) for d in draws)
    want_m, want_s, want_t = _jax_steps(jcfg, variables, batch, rngs)

    start = jax_variables_to_state_dict(variables)
    state = create_train_state(tcfg, det, start)
    step = make_train_step(tcfg, det)
    got_m = []
    for d in draws:
        state, m = step(state, torch_tree(batch), d)
        got_m.append({k: float(v) for k, v in m.items()})
    for i, (g, w) in enumerate(zip(got_m, want_m)):
        assert set(g) == set(w), set(g) ^ set(w)
        for k in w:
            close_rel(g[k], w[k], what=f"step {i} {k}")
    assert want_m[0]["num_pseudo_labels"] > 0
    tol = 1e-5 if adamw else 1e-6
    for module, want, what in ((state.student, want_s, "student"),
                               (state.teacher, want_t, "teacher")):
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        err, beyond, total = 0.0, 0, 0
        for k, w in want.items():
            diff = (got[k].detach() - w).abs()
            kb = _key_bias_mask(k, w.shape) if adamw else torch.zeros_like(
                diff, dtype=torch.bool)
            beyond += int((diff[~kb] > tol).sum())
            total += diff.numel()
            err = max(err, float(diff.max()))
        want_moved = max(max_err(want[k].numpy(), start[k].numpy())
                         for k in want)
        print(f"{optimizer} {what} after 2 steps: max abs err {err:.3g}, "
              f"{beyond} of {total} entries beyond {tol:g}; largest move "
              f"{want_moved:.3g}")
        assert want_moved >= 10 * tol
        if adamw:
            assert beyond <= 0.01 * total and err <= 4 * LR
        else:
            assert err <= tol


def test_draw_step_draws_drop_path_masks(dets):
    _, _, tdet = dets
    a = draw_step(torch.Generator().manual_seed(3), tdet, 2, 2)
    b = draw_step(torch.Generator().manual_seed(3), tdet, 2, 2)
    for stream in ("strong", "distill"):
        m = a[stream]["drop"]
        assert m.shape == (2, 3, 2) and m.dtype == torch.bool
        assert m[:, 0].all()  # block 0 has rate 0
        assert torch.equal(m, b[stream]["drop"])
    assert "drop" not in a["teacher"]
