"""Port parity of the DAOD training step against the JAX package, on the
CPU, at the tiny config (ResNet-26, canvas 128, 3 classes) with the
flagship's recipe (``configs/cityscapes/ALDI-Best-Cityscapes.yaml``:
labeled_strong + distill, EMA, soft distillation, erasing on the labeled
stream, MIC on the unlabeled one, one backward per stream) in float32.

Both packages get the same seeded weights and the same random draws (the
JAX step's own, through ``tests/torch_port_draws.py``); the JAX side runs
jitted. The full step uses a saturated-sampling config: every anchor that
is not ignored and every ROI candidate is sampled, so the sampled sets are
the same whatever the draws and every loss is a sum over them.

Tolerances: float32 convolutions and matrix products sum in another order
in each framework, about 1e-6 relative per layer, so losses are held to
1e-4 relative; gradients to 1e-4 of each tensor's largest magnitude;
parameters after the steps to 1e-5 absolute; sampled indices and masks
are exact, and pseudo-label boxes (up to 128 px) 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.structures import Instances as JaxInstances
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models.rpn import label_anchors_sampled
from aldi_tpu_torch.ops.match_kernel import low_quality_mask, match_iou
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd, roi_align_fwd
from aldi_tpu_torch.structures import Instances
from tests import torch_port_draws as draws_from
from tests.torch_port_common import max_err, seeded_variables

FLAGSHIP = "configs/cityscapes/ALDI-Best-Cityscapes.yaml"
KERNELS = (match_iou, low_quality_mask, roi_align_fwd, roi_align_bwd)


def daod_cfg(get_cfg, saturated=False, **overrides):
    cfg = get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.RESNETS.DEPTH = 26
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    rpn = cfg.MODEL.RPN
    rpn.PRE_NMS_TOPK_TRAIN, rpn.POST_NMS_TOPK_TRAIN = 64, 32
    rpn.PRE_NMS_TOPK_TEST, rpn.POST_NMS_TOPK_TEST = 64, 32
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.5
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 0
    if saturated:
        rpn.BATCH_SIZE_PER_IMAGE = 4096  # >= the canvas's 4092 anchors
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 40  # 32 proposals + 8 gt
        cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
        # the second step's EMA blend moves the teacher by 1 - ALPHA of the
        # student's first move: at the flagship's 0.9996 that is below the
        # parameters' tolerance, at 0.9 it stands far above it
        cfg.EMA.ALPHA = 0.9
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def make_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 8, 4), np.float32)
    classes = np.zeros((b, 8), np.int32)
    valid = np.zeros((b, 8), bool)
    for i in range(b):
        for g in range(3 + i):
            x0, y0 = rng.uniform(0, 80, 2)
            w, h = rng.uniform(12, 48, 2)
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


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def jax_tree(tree):
    if isinstance(tree, dict):
        return {k: jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def close_rel(got, want, rtol=1e-4, what=""):
    got, want = float(got), float(want)
    print(f"{what}: {got:.6g} vs {want:.6g}")
    assert abs(got - want) <= rtol * max(abs(want), 1e-3), what


def port_detector(cfg, variables):
    det = build_detector(cfg, device="cpu")
    det.module.load_state_dict(jax_variables_to_state_dict(variables))
    return det


@pytest.fixture(scope="module")
def dets():
    jcfg, tcfg = daod_cfg(jax_get_cfg), daod_cfg(port_get_cfg)
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed=3)
    return jdet, variables, port_detector(tcfg, variables)


def _gt(batch, cls):
    lab = batch["labeled"]
    return cls(boxes=lab["boxes"], classes=lab["classes"],
               valid=lab["valid"])


# ------------------------------------------------------------- forward
def test_forward_train_losses_and_grads_match_jax(dets):
    jdet, variables, tdet = dets
    batch = make_batch()
    lab = batch["labeled"]
    rng = jax.random.PRNGKey(21)

    def loss_fn(params):
        v = {"params": params, "frozen": variables["frozen"]}
        losses, _ = jdet.forward_train(
            v, jnp.asarray(lab["image"]), jnp.asarray(lab["sizes"]),
            _gt(jax_tree(batch), JaxInstances), rng)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    n_anchors = tdet.anchors_cat.shape[0]
    draws = draws_from.forward_train_draws(rng, tdet.cfg, 2, n_anchors)
    tb = torch_tree(batch)
    losses, aux = tdet.forward_train(tdet.module, tb["labeled"]["image"],
                                     tb["labeled"]["sizes"],
                                     _gt(tb, Instances), draws)
    assert set(losses) == set(want)
    for k in want:
        close_rel(losses[k], want[k], what=k)
    sum(losses.values()).backward()
    want_g = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    params = dict(tdet.module.named_parameters())
    worst = 0.0
    for name, w in want_g.items():
        p = params[name]
        if not p.requires_grad:  # frozen stem/res2: JAX's gradient is 0
            assert p.grad is None and not w.abs().max() > 0, name
            continue
        scale = max(float(w.abs().max()), 1e-6)
        worst = max(worst, max_err(p.grad.numpy(), w.numpy()) / scale)
    print(f"gradients: worst max abs err / tensor scale {worst:.3g}")
    assert worst <= 1e-4
    assert aux["sampled"]["is_pos"].any()


def test_teacher_ctx_and_distill_losses_match_jax(dets):
    """The teacher context, then the distill losses. The low-quality match
    tests IoU *equality*, so pseudo-label boxes one float32 ulp apart (the
    two frameworks' convolutions sum in another order) can break an exact
    tie between anchors; each discontinuous step is therefore compared on
    identical inputs: the anchor sampler and the student's pass both take
    the JAX package's pseudo-labels."""
    jdet, variables, tdet = dets
    batch = make_batch(seed=1)
    uw, lab = batch["unlabeled"], batch["labeled"]
    k_ctx, k_train = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    cfg = tdet.cfg
    jv = jax_tree(dict(variables))
    ctx, pseudo, metrics = jax.jit(
        lambda v, im, sz: jdet.forward_teacher_ctx(
            v, im, sz, k_ctx, threshold=0.5, max_gt=8))(
        jv, jnp.asarray(uw["image"]), jnp.asarray(uw["sizes"]))

    def student_and_distill(v, im, sz, gt):
        _, s_aux = jdet.forward_train(v, im, sz, gt, k_train)
        return jdet.distill_losses(v, ctx, s_aux)

    jgt = JaxInstances(pseudo.boxes, pseudo.classes, pseudo.valid)
    want_d = jax.jit(student_and_distill)(
        jv, jnp.asarray(lab["image"]), jnp.asarray(lab["sizes"]), jgt)

    n_anchors = tdet.anchors_cat.shape[0]
    rpn = cfg.MODEL.RPN
    t_draws = draws_from.label_anchors_draws(
        k_ctx, 2, n_anchors, rpn.BATCH_SIZE_PER_IMAGE, rpn.POSITIVE_FRACTION)
    tb = torch_tree(batch)
    tctx, tpseudo, tmetrics = tdet.forward_teacher_ctx(
        tdet.module, tb["unlabeled"]["image"], tb["unlabeled"]["sizes"],
        t_draws, threshold=0.5, max_gt=8)
    # pseudo-labels
    np.testing.assert_array_equal(tpseudo.valid.numpy(), pseudo.valid)
    m = np.asarray(pseudo.valid)
    assert m.sum() > 0  # there are pseudo-labels to compare
    assert max_err(tpseudo.boxes.numpy()[m], np.asarray(pseudo.boxes)[m]) \
        <= 1e-3
    np.testing.assert_array_equal(tpseudo.classes.numpy(), pseudo.classes)
    close_rel(tmetrics["num_pseudo_labels"], metrics["num_pseudo_labels"],
              what="num_pseudo_labels")
    # the anchor set: the port's own pseudo-labels wired through, and the
    # JAX package's sampled set from the JAX package's pseudo-labels
    ppseudo = Instances(*(torch_tree(np.asarray(x)) for x in (
        pseudo.boxes, pseudo.classes, pseudo.valid)))
    own = _sample_anchors(tdet, tpseudo, t_draws)
    same = _sample_anchors(tdet, ppseudo, t_draws)
    for i, k in enumerate(("anchor_idx", "anchor_valid", "anchor_fg")):
        assert torch.equal(tctx[k], own[i]), k
        np.testing.assert_array_equal(same[i].numpy(), ctx[k], k)
    # the teacher's head outputs at the sampled anchors
    _, t_logits, t_deltas, _ = tdet.forward_teacher(
        tdet.module, tb["unlabeled"]["image"], tb["unlabeled"]["sizes"])
    idx = same[0]
    got_t = {"t_obj": torch.gather(t_logits, 1, idx),
             "t_delta": torch.gather(t_deltas, 1,
                                     idx[..., None].expand(-1, -1, 4))}
    for k, v in got_t.items():
        scale = float(np.abs(ctx[k]).max())
        assert max_err(v.numpy(), ctx[k]) <= 1e-4 * scale, k
    # distill losses on the JAX package's pseudo-labels and anchor set
    tctx.update(anchor_idx=idx, anchor_valid=same[1], anchor_fg=same[2],
                **got_t)
    s_draws = draws_from.forward_train_draws(k_train, cfg, 2, n_anchors)
    with torch.no_grad():
        _, s_aux = tdet.forward_train(tdet.module, tb["labeled"]["image"],
                                      tb["labeled"]["sizes"], ppseudo,
                                      s_draws)
        got_d = tdet.distill_losses(tdet.module, tctx, s_aux)
    assert set(got_d) == set(want_d) == {
        "loss_obj_bce", "loss_rpn_l1", "loss_cls_ce", "loss_roih_l1"}
    for k in want_d:
        close_rel(got_d[k], want_d[k], what=k)


def _sample_anchors(det, pseudo, draws):
    return label_anchors_sampled(
        det.anchors_cat, pseudo.boxes, pseudo.valid, draws,
        det.rpn_params["batch_size_per_image"],
        det.rpn_params["positive_fraction"])


# ---------------------------------------------------------- whole step
def _jax_steps(cfg, variables, batch, rngs):
    jdet = jax_build_detector(cfg)
    state, tx = jax_create_train_state(cfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params,
                          frozen=jax_tree(dict(variables["frozen"])),
                          opt_state=tx.init(params),
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


def _port_steps(cfg, variables, batch, draws):
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det,
                               jax_variables_to_state_dict(variables))
    step = make_train_step(cfg, det)
    metrics = []
    for d in draws:
        state, m = step(state, torch_tree(batch), d)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module")
def saturated_steps():
    """Two full DAOD steps of both packages (the second blends the EMA
    teacher), saturated sampling, one backward per stream."""
    jcfg = daod_cfg(jax_get_cfg, saturated=True)
    tcfg = daod_cfg(port_get_cfg, saturated=True)
    variables = seeded_variables(jax_build_detector(jcfg), seed=5)
    batch = make_batch(seed=2)
    rngs = [jax.random.PRNGKey(41), jax.random.PRNGKey(42)]
    n_anchors = build_detector(tcfg, device="cpu").anchors_cat.shape[0]
    draws = [draws_from.train_step_draws(r, tcfg, 2, 2, n_anchors)
             for r in rngs]
    for k in KERNELS:
        k.launches = 0
    port = _port_steps(tcfg, variables, batch, draws)
    launches = [k.launches for k in KERNELS]
    return (_jax_steps(jcfg, variables, batch, rngs), port, launches,
            (tcfg, variables, batch, draws))


def test_daod_step_matches_jax(saturated_steps):
    """Per-key metrics and the student's and the teacher's parameters after
    two steps. (With these seeds no pseudo-label box sits where a one-ulp
    difference breaks a low-quality tie; see the teacher-context test.)"""
    (want_m, want_s, want_t), (got_m, state), _, rest = saturated_steps
    start = jax_variables_to_state_dict(rest[1])
    for step, (g, w) in enumerate(zip(got_m, want_m)):
        assert set(g) == set(w), (set(g) ^ set(w))
        for k in w:
            close_rel(g[k], w[k], what=f"step {step} {k}")
    assert want_m[0]["num_pseudo_labels"] > 0
    assert want_m[0]["loss_cls_ce_distill"] > 0
    for module, want, what in ((state.student, want_s, "student"),
                               (state.teacher, want_t, "teacher")):
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        err = max(max_err(got[k].detach().numpy(), want[k].numpy())
                  for k in want)
        moved = max(max_err(got[k].detach().numpy(), start[k].numpy())
                    for k in want)
        want_moved = max(max_err(want[k].numpy(), start[k].numpy())
                         for k in want)
        print(f"{what} after 2 steps: max abs err {err:.3g}, largest move "
              f"{moved:.3g} (JAX {want_moved:.3g})")
        # the move itself is held far above the tolerance, so a wrong blend
        # (a wrong alpha, the EMA after the optimizer step) shows
        assert err <= 1e-5 and want_moved >= 100 * 1e-5


def test_daod_step_on_cpu_launches_no_kernel(saturated_steps):
    assert saturated_steps[2] == [0, 0, 0, 0]


def test_backward_at_end_matches_stream_backward(saturated_steps):
    """SOLVER.BACKWARD_AT_END true (one backward of the summed streams)
    gives the losses and parameters of false (one backward per stream)."""
    _, (seq_m, seq_state), _, (_, variables, batch, draws) = saturated_steps
    cfg = daod_cfg(port_get_cfg, saturated=True,
                   **{"SOLVER.BACKWARD_AT_END": True})
    joint_m, joint_state = _port_steps(cfg, variables, batch, draws)
    for g, w in zip(joint_m, seq_m):
        for k in w:
            close_rel(g[k], w[k], rtol=1e-5, what=k)
    for a, b in ((joint_state.student, seq_state.student),
                 (joint_state.teacher, seq_state.teacher)):
        pb = dict(b.named_parameters())
        for name, p in a.named_parameters():
            assert max_err(p.detach().numpy(), pb[name].detach().numpy()) \
                <= 1e-6, name


def test_frozen_stages_do_not_move(saturated_steps):
    _, (_, state), _, (_, variables, _, _) = saturated_steps
    start = jax_variables_to_state_dict(variables)
    for name, p in state.student.named_parameters():
        frozen = ".stem." in name or ".res2." in name
        assert p.requires_grad != frozen, name
        if frozen:
            assert torch.equal(p.detach(), start[name]), name
    params = {id(p) for g in state.optimizer.param_groups
              for p in g["params"]}
    assert all(id(p) in params for p in state.student.parameters()
               if p.requires_grad)
    assert not any(id(p) in params for p in state.student.parameters()
                   if not p.requires_grad)


# ------------------------------------------------ state and checkpoints
def test_train_state_round_trips_jax_variables(dets):
    """A JAX TrainState's params, frozen and ema_params (seeded numpy
    trees) become the port's student and teacher, one to one: every JAX
    leaf has one port tensor with its values, and the teacher shares the
    student's FrozenBN buffers."""
    jdet, variables, _ = dets
    ema = seeded_variables(jdet, seed=9)["params"]
    tcfg = daod_cfg(port_get_cfg)
    det = build_detector(tcfg, device="cpu")
    weights = jax_variables_to_state_dict(variables)
    teacher_weights = jax_variables_to_state_dict(
        {"params": ema, "frozen": variables["frozen"]})
    n_leaves = len(jax.tree_util.tree_leaves(dict(variables)))
    assert len(weights) == n_leaves == len(det.module.state_dict())
    state = create_train_state(tcfg, det, weights, teacher_weights)
    for module, want in ((state.student, weights),
                         (state.teacher, teacher_weights)):
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    s_buf = dict(state.student.named_buffers())
    for name, buf in state.teacher.named_buffers():
        assert buf is s_buf[name], name
    assert not any(p.requires_grad for p in state.teacher.parameters())


# ------------------------------------------------------------ the rules
@pytest.mark.parametrize("key,value", [
    ("DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED", True),
    ("DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED", True),
    ("TPU.RPN_LOSS_IMPL", "dense"),
])
def test_unported_training_configs_raise(key, value):
    cfg = daod_cfg(port_get_cfg, **{key: value})
    det = build_detector(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(cfg, det)


def test_adamw_raises():
    """ADAMW is ported (the ViTDet slice): it builds; an optimizer the JAX
    package does not know still raises."""
    cfg = daod_cfg(port_get_cfg, **{"SOLVER.OPTIMIZER": "ADAMW"})
    det = build_detector(cfg, device="cpu")
    assert isinstance(create_train_state(cfg, det).optimizer,
                      torch.optim.AdamW)
    cfg = daod_cfg(port_get_cfg, **{"SOLVER.OPTIMIZER": "LAMB"})
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        create_train_state(cfg, build_detector(cfg, device="cpu"))


def test_draw_step_is_seeded_and_shaped():
    cfg = daod_cfg(port_get_cfg)
    det = build_detector(cfg, device="cpu")
    a = draw_step(torch.Generator().manual_seed(3), det, 2, 2)
    b = draw_step(torch.Generator().manual_seed(3), det, 2, 2)
    assert set(a) == {"strong", "aug_labeled", "teacher", "distill",
                      "aug_unlabeled"}
    n = det.anchors_cat.shape[0]
    assert a["teacher"]["pos_keys"].shape == (2, n)
    assert a["distill"]["roi"]["fill"].shape == (2, 32 + 8)
    assert a["aug_labeled"]["erase_noise"].shape == (2, 128, 128, 3)
    assert "mic_u" in a["aug_unlabeled"] and "mic_u" not in a["aug_labeled"]

    def flat(tree):
        return [x for v in tree.values()
                for x in (flat(v) if isinstance(v, dict) else [v])]

    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
