"""Port parity of the YOLOv5 family (``aldi_tpu_torch/models/yolo.py``)
against the JAX package, on the CPU, at the sizes of ``tests/test_yolo.py``:
yolov5n multiples (0.33, 0.25), 3 classes, canvas 128, 2 images, MAX_GT 8,
in float32. The JAX side runs un-jitted, but for the whole network in
training mode and the teacher's pass, which run jitted: un-jitted, flax
dispatches the network op by op, and one gradient of the tiny detector
took 34 s on an 8-core CPU against 7.7 s jitted, compile included. Both
packages get the same seeded
weights (``tests/torch_port_common.py`` ``yolo_variables``, the BatchNorm
running statistics included) through ``jax_variables_to_state_dict``.

Tolerances, float32: rtol 1e-5 unless a reason stands beside one. The
assigner is exact. Whole-network outputs are held to 1e-4 of their scale:
the two frameworks' convolutions sum in another order, about 1e-6 relative
per layer, over the 60 layers of the network.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models import yolo as jax_yolo
from aldi_tpu.structures import Instances as JaxInstances
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import (
    jax_variables_to_state_dict, reference_state_dict_to_port)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models import yolo
from aldi_tpu_torch.structures import Instances
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_common import max_err, yolo_cfg, yolo_variables
from tests.torch_rcnn_oracle import randomize
from tests.torch_yolo_oracle import build_yolov5, yolo_forward

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(got, want, rtol=RTOL, atol=0.0, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = max_err(got, want)
    print(f"{what}: max abs err {err:.3g} (scale {np.abs(want).max():.3g})")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def scaled_err(got, want):
    """max |got - want| / max |want|."""
    want = np.asarray(want, np.float64)
    return max_err(got, want) / max(float(np.abs(want).max()), 1e-12)


@pytest.fixture(scope="module")
def dets():
    """(JAX detector, its seeded variables, the port's detector on the CPU
    with the same weights and statistics)."""
    jdet = jax_build_detector(yolo_cfg(jax_get_cfg))
    variables = _np(yolo_variables(jdet, seed=3))
    tdet = build_detector(yolo_cfg(port_get_cfg), device="cpu")
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    return jdet, variables, tdet


def tiny_batch(seed=0, b=2):
    """Images and gt boxes of 12-60 px, the first image with 3 boxes and
    the second with 4 (padded to 8), classes 0..2."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 8, 4), np.float32)
    classes = np.zeros((b, 8), np.int32)
    valid = np.zeros((b, 8), bool)
    for i in range(b):
        for g in range(3 + i):
            x0, y0 = rng.uniform(0, 64, 2)
            w, h = rng.uniform(12, 60, 2)
            boxes[i, g] = [x0, y0, min(x0 + w, 127), min(y0 + h, 127)]
            classes[i, g] = rng.integers(0, 3)
            valid[i, g] = True
    images = rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32)
    sizes = np.array([[128, 128], [112, 120]], np.int32)[:b]
    return images, sizes, boxes, classes, valid


# --------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_conv_bn_silu_matches_flax(train):
    """``ConvBnSiLU`` against flax's (``mutable=["batch_stats"]`` in
    training mode): the output, the updated running statistics, and the
    gradients of a random projection of the output. 2 images of 4x4 cells:
    N = 32, so torch's unbiased update would be larger by 32/31 (3%)."""
    rng = np.random.default_rng(0)
    cin, cout = 5, 8
    x = rng.normal(size=(2, 4, 4, cin)).astype(np.float32) + 0.3
    proj = rng.normal(size=(2, 4, 4, cout)).astype(np.float32)
    net = jax_yolo.ConvBnSiLU(cout, 3)
    v = _np(net.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bn"]["scale"] = rng.uniform(0.5, 1.5, cout).astype(
        np.float32)
    v["params"]["bn"]["bias"] = rng.normal(size=cout).astype(np.float32)
    v["batch_stats"]["bn"]["mean"] = rng.normal(size=cout).astype(
        np.float32) * 0.1
    v["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 1.5, cout).astype(
        np.float32)

    def f(params, x):
        y, mut = net.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, x, train,
                           mutable=["batch_stats"])
        return (y * proj).sum(), (y, mut)

    (_, (want_y, mut)), (want_gp, want_gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    layer = yolo.ConvBnSiLU(cin, cout, 3)
    sd = jax_variables_to_state_dict(
        {"params": {"b0": v["params"]}, "batch_stats": {
            "b0": v["batch_stats"]}})
    layer.load_state_dict({k[len("b0."):]: t for k, t in sd.items()})
    layer.train(train)
    tx = _t(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = layer(tx).permute(0, 2, 3, 1)
    (y * _t(proj)).sum().backward()
    assert_close(y.detach().numpy(), want_y, atol=1e-6, what="output")
    assert_close(tx.grad.permute(0, 2, 3, 1).numpy(), want_gx, atol=1e-6,
                 what="input gradient")
    got_gp = jax_variables_to_state_dict({"params": {"b0": _np(want_gp)}})
    for name, p in layer.named_parameters():
        assert_close(p.grad.numpy(), got_gp["b0." + name].numpy(), atol=1e-6,
                     what=f"gradient of {name}")
    bn = layer.bn
    stats = mut.get("batch_stats", v["batch_stats"])["bn"]
    assert_close(bn.running_mean.numpy(), stats["mean"], what="running mean")
    assert_close(bn.running_var.numpy(), stats["var"], what="running var")
    if train:
        # the biased batch variance, where torch.nn.BatchNorm2d's unbiased
        # update differs by far more than the tolerance
        conv = layer.conv(_t(x).permute(0, 3, 1, 2)).detach()
        ref = torch.nn.BatchNorm2d(cout, eps=1e-3, momentum=0.03)
        ref.running_mean.copy_(_t(v["batch_stats"]["bn"]["mean"]))
        ref.running_var.copy_(_t(v["batch_stats"]["bn"]["var"]))
        ref.train()(conv)
        biased = conv.var(dim=(0, 2, 3), unbiased=False)
        want_var = 0.97 * _t(v["batch_stats"]["bn"]["var"]) + 0.03 * biased
        assert_close(bn.running_var.numpy(), want_var.numpy(),
                     what="running var vs biased update")
        gap = (ref.running_var - bn.running_var).abs().max().item()
        print(f"torch BatchNorm2d's unbiased update differs by {gap:.3g}")
        assert gap > 10 * RTOL * float(ref.running_var.max())


# ------------------------------------------------------ assigner and loss
def _gt_with_duplicates():
    """Boxes that exercise every branch of the assigner: centers just
    below and above a cell's half (both neighbors), near the borders
    (neighbors cut), sizes that match none, one or several anchors, an
    invalid slot, and two boxes of one image whose centers share a cell
    and their anchors, so that (cell, anchor) candidates repeat."""
    boxes = np.array([
        [[20.0, 20.0, 52.0, 44.0], [22.0, 21.0, 50.0, 45.0],
         [0.5, 0.5, 14.0, 9.0], [100.0, 110.0, 127.5, 127.9],
         [30.0, 60.0, 90.0, 120.0], [5.0, 5.0, 6.0, 6.0],
         [0.0, 0.0, 0.0, 0.0], [60.0, 60.0, 64.0, 127.0]],
        [[8.2, 8.7, 40.1, 31.9], [63.9, 64.1, 64.9, 65.0],
         [0.0, 0.0, 127.0, 127.0], [40.0, 4.0, 88.0, 20.0],
         [10.0, 90.0, 30.0, 126.0], [70.0, 30.0, 110.0, 100.0],
         [11.0, 11.0, 38.0, 30.0], [2.0, 3.0, 4.0, 5.0]]], np.float32)
    classes = np.array([[0, 1, 2, 0, 1, 2, 0, 1], [2, 1, 0, 0, 1, 2, 2, 1]],
                       np.int32)
    valid = np.ones((2, 8), bool)
    valid[0, 6] = False
    return boxes, classes, valid


FEAT_HWS = [(16, 16), (8, 8), (4, 4)]


def test_build_targets_exact():
    boxes, classes, valid = _gt_with_duplicates()
    want = jax_yolo.build_targets(jnp.asarray(boxes), jnp.asarray(classes),
                                  jnp.asarray(valid), FEAT_HWS)
    got = yolo.build_targets(_t(boxes), _t(classes), _t(valid), FEAT_HWS)
    n_valid = 0
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert tuple(g[k].shape) == w[k].shape, (lvl, k)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=f"level {lvl} {k}")
        n_valid += int(g["valid"].sum())
        print(f"level {lvl}: {int(g['valid'].sum())} valid candidates")
    assert n_valid > 0


def _random_preds(seed, b=2, nc=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, w, 3, 5 + nc)).astype(np.float32)
            for h, w in FEAT_HWS]


def test_ciou_matches_jax():
    rng = np.random.default_rng(1)
    b1 = np.abs(rng.normal(size=(64, 4)).astype(np.float32)) * 4 + 0.1
    b2 = np.abs(rng.normal(size=(64, 4)).astype(np.float32)) * 4 + 0.1
    b2[:4] = b1[:4]  # identical boxes: CIoU 1
    want = jax_yolo.ciou(jnp.asarray(b1), jnp.asarray(b2))
    got = yolo.ciou(_t(b1), _t(b2))
    assert_close(got.numpy(), want, atol=1e-6, what="ciou")
    np.testing.assert_allclose(got[:4].numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_yolo_losses_match_jax(label_smoothing):
    """The three losses and their gradients with respect to the
    predictions, on gt whose (cell, anchor) candidates repeat: the
    objectness target keeps the largest IoU of each repeated slot."""
    boxes, classes, valid = _gt_with_duplicates()
    preds = _random_preds(2)
    gains = dict(box_gain=0.05, obj_gain=0.7, cls_gain=0.3,
                 label_smoothing=label_smoothing)
    jt = jax_yolo.build_targets(jnp.asarray(boxes), jnp.asarray(classes),
                                jnp.asarray(valid), FEAT_HWS)

    def f(ps):
        losses = jax_yolo.yolo_losses(ps, jt, 3, **gains)
        return sum(losses.values()), losses

    (_, want), want_g = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(p) for p in preds])
    tt = yolo.build_targets(_t(boxes), _t(classes), _t(valid), FEAT_HWS)
    flat = torch.cat([_flat_slots(t, p.shape)[t["valid"]]
                      for t, p in zip(tt, preds)])
    repeats = flat.numel() - flat.unique().numel()
    print(f"{flat.numel()} valid candidates, {repeats} repeated slots")
    assert repeats > 0
    tp = [_t(p).requires_grad_(True) for p in preds]
    got = yolo.yolo_losses(tp, tt, 3, **gains)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k].item(), float(want[k]), what=k)
    sum(got.values()).backward()
    for lvl, (p, g) in enumerate(zip(tp, want_g)):
        assert scaled_err(p.grad.numpy(), g) <= RTOL, lvl


def _flat_slots(t, shape):
    """A level's (image, cell, anchor) slot per candidate [B, G, A, 3]."""
    b, h, w, na, _ = shape
    bi = torch.arange(b)[:, None, None, None]
    ai = torch.arange(na)[None, None, :, None]
    return ((bi * h + t["cj"]) * w + t["ci"]) * na + ai


def test_decode_and_inference_match_jax(dets):
    """``decode_predictions`` and the inference tail (top 2000, NMS, top
    10) on random predictions: scores and boxes rtol 1e-5, valid and
    classes exact."""
    jdet, _, tdet = dets
    preds = _random_preds(4)
    want = jax_yolo.decode_predictions([jnp.asarray(p) for p in preds], 3,
                                       0.001)
    got = yolo.decode_predictions([_t(p) for p in preds], 3, 0.001)
    for k, g, w in zip(("boxes", "scores", "classes", "valid"), got, want):
        assert tuple(g.shape) == w.shape, k
        assert_close(g.numpy(), w, atol=1e-5 if k == "boxes" else 0.0,
                     what=f"decode {k}")
    sizes = np.array([[128, 128], [100, 120]], np.int32)
    want = jdet._inference_from_preds([jnp.asarray(p) for p in preds],
                                      jnp.asarray(sizes))
    got = tdet._inference_from_preds([_t(p) for p in preds], _t(sizes))
    _same_detections(got, want)


def _same_detections(got, want):
    (gb, gs, gc, gv), (wb, ws, wc, wv) = got, [np.asarray(x) for x in want]
    np.testing.assert_array_equal(gv.numpy(), wv)
    assert wv.sum() > 0
    np.testing.assert_array_equal(gc.numpy()[wv], wc[wv])
    # boxes in canvas pixels (up to 128): 1e-5 relative is 1.3e-3 px
    assert_close(gb.numpy()[wv], wb[wv], atol=2e-3, what="boxes")
    assert_close(gs.numpy()[wv], ws[wv], what="scores")
    print(f"{int(wv.sum())} detections")


# ------------------------------------------------------- whole detector
def test_detector_train_mode_matches_jax(dets):
    """``forward_train``: the losses, the running statistics it leaves
    behind (every BatchNorm's), the parameters' gradients; and the module
    is back in eval mode after it."""
    jdet, variables, tdet = dets
    images, sizes, boxes, classes, valid = tiny_batch()

    def f(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        losses, aux = jdet.forward_train(
            v, jnp.asarray(images), jnp.asarray(sizes),
            JaxInstances(jnp.asarray(boxes), jnp.asarray(classes),
                         jnp.asarray(valid)), None)
        return sum(losses.values()), (losses, aux["mutated_vars"])

    (_, (want, mutated)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"])
    module = tdet.module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    gt = Instances(_t(boxes), _t(classes), _t(valid))
    got, aux = tdet.forward_train(module, _t(images), _t(sizes), gt)
    assert not module.training
    assert set(got) == set(want) == {"loss_box", "loss_obj", "loss_cls"}
    for k in want:  # 60 layers of float32 convolutions: 1e-4
        assert_close(got[k].item(), float(want[k]), rtol=1e-4, what=k)
    sum(got.values()).backward()
    want_g = jax_variables_to_state_dict({"params": _np(grads)})
    worst = max(scaled_err(p.grad.numpy(), want_g[n].numpy())
                for n, p in module.named_parameters())
    print(f"gradients: worst max abs err / tensor scale {worst:.3g}")
    # BatchNorm's batch-statistics gradient subtracts two means from every
    # cotangent: a cancellation that doubles the rounding of a layer
    assert worst <= 2e-4
    want_s = jax_variables_to_state_dict(
        {"batch_stats": _np(mutated["batch_stats"])})
    worst = 0.0
    for name, buf in module.named_buffers():
        worst = max(worst, scaled_err(buf.numpy(), want_s[name].numpy()))
    print(f"running statistics: worst max abs err / scale {worst:.3g}")
    assert worst <= 1e-4
    module.zero_grad(set_to_none=True)


def test_detector_eval_mode_matches_jax(dets):
    """``forward_inference`` in eval mode on the running statistics: the
    raw predictions, then the detections; no statistic moves."""
    jdet, variables, tdet = dets
    module = tdet.module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    before = {k: v.clone() for k, v in module.state_dict().items()}
    images, sizes, *_ = tiny_batch(seed=1)
    jv = {"params": variables["params"],
          "batch_stats": variables["batch_stats"]}
    want_p, _, _ = jdet._model_fwd(jv, jnp.asarray(images), False)
    with torch.no_grad():
        got_p, _ = tdet._model_fwd(module, _t(images), False)
    for lvl, (g, w) in enumerate(zip(got_p, want_p)):
        err = scaled_err(g.numpy(), w)
        print(f"level {lvl} predictions: max err / scale {err:.3g}")
        assert err <= 1e-4
    want = jdet.forward_inference(jv, jnp.asarray(images), jnp.asarray(sizes))
    got = tdet.forward_inference(_t(images), _t(sizes))
    _same_detections(got, want)
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_teacher_ctx_and_distill_losses_match_jax(dets):
    """The teacher's pseudo-labels (eval mode: its statistics stay put)
    and the soft losses of the ALDI-Yolo recipe (objectness, classification
    and regression) on the student's training-mode pass."""
    jdet, variables, tdet = dets
    images, sizes, *_ = tiny_batch(seed=2)
    jv = {"params": variables["params"],
          "batch_stats": variables["batch_stats"]}
    ctx, pseudo, metrics = jax.jit(lambda v, im, sz: jdet.forward_teacher_ctx(
        v, im, sz, None, threshold=0.0, max_gt=8))(
        jv, jnp.asarray(images), jnp.asarray(sizes))
    module = tdet.module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    tctx, tpseudo, tmetrics = tdet.forward_teacher_ctx(
        module, _t(images), _t(sizes), None, threshold=0.0, max_gt=8)
    np.testing.assert_array_equal(tpseudo.valid.numpy(), pseudo.valid)
    m = np.asarray(pseudo.valid)
    assert m.sum() > 0
    np.testing.assert_array_equal(tpseudo.classes.numpy()[m],
                                  np.asarray(pseudo.classes)[m])
    assert max_err(tpseudo.boxes.numpy()[m], np.asarray(pseudo.boxes)[m]) \
        <= 2e-3
    assert float(tmetrics["num_pseudo_labels"]) == float(
        metrics["num_pseudo_labels"])
    for key in ("mean", "var"):  # the teacher ran on its statistics
        np.testing.assert_array_equal(
            module.b0.bn.running_mean.numpy() if key == "mean"
            else module.b0.bn.running_var.numpy(),
            variables["batch_stats"]["b0"]["bn"][key])

    def student_and_distill(v, im, sz, gt):
        _, s_aux = jdet.forward_train(v, im, sz, gt, None)
        return jdet.distill_losses(v, ctx, s_aux)

    want = jax.jit(student_and_distill)(
        jv, jnp.asarray(images), jnp.asarray(sizes),
        JaxInstances(pseudo.boxes, pseudo.classes, pseudo.valid))
    pgt = Instances(*(_t(x) for x in (pseudo.boxes, pseudo.classes,
                                      pseudo.valid)))
    tctx = {"head_outputs": [_t(p) for p in ctx["head_outputs"]],
            "pseudo_gt": pgt}
    with torch.no_grad():
        _, t_aux = tdet.forward_train(module, _t(images), _t(sizes), pgt)
        got = tdet.distill_losses(module, tctx, t_aux)
    assert set(got) == set(want) == {"loss_soft_obj", "loss_soft_cls",
                                     "loss_soft_reg"}
    for k in want:
        assert_close(got[k].item(), float(want[k]), rtol=1e-4, what=k)


# ------------------------------------------------------------ converters
def test_jax_variables_converter_covers_the_module(dets):
    """Every name of the JAX tree, params and batch_stats, lands on one of
    the port module's, and the port has no other."""
    _, variables, tdet = dets
    sd = jax_variables_to_state_dict(variables)
    n_jax = sum(len(flatten_dict(variables[c])) for c in ("params",
                                                          "batch_stats"))
    assert len(sd) == n_jax
    assert set(sd) == set(tdet.module.state_dict())
    assert all(sd[k].shape == v.shape
               for k, v in tdet.module.state_dict().items())


@pytest.mark.parametrize("prefix", ["model.", "", "model.model."])
def test_reference_state_dict_converter(prefix, dets):
    """The ultralytics layout (``tests/torch_yolo_oracle.py`` ``build_yolov5``,
    randomized) under each wrapper prefix: every port name is read from it,
    and the port in eval mode computes the oracle's predictions."""
    _, _, tdet = dets
    root = randomize(build_yolov5(3, 0.33, 0.25), seed=7)
    sd = {prefix + k[len("model."):]: v for k, v in root.state_dict().items()}
    target = tdet.module.state_dict()
    missing = []

    class Log:
        def info(self, msg):
            missing.append(msg)

    port = reference_state_dict_to_port(sd, target, Log())
    assert not [m for m in missing if "not found" in m], missing
    tdet.module.load_state_dict(port)
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = yolo_forward(root, _t(x).permute(0, 3, 1, 2))
    with torch.no_grad():
        got, _ = tdet.module.eval()(_t(x).permute(0, 3, 1, 2))
    for lvl, (g, w) in enumerate(zip(got, want)):
        err = scaled_err(g.numpy(), w.numpy())
        print(f"P{lvl + 3}: max err / scale {err:.3g}")
        assert err <= 1e-4


# ----------------------------------------------------------------- build
def test_build_detector_builds_the_published_yolo(monkeypatch):
    """``configs/cityscapes/ALDI-Yolo-Cityscapes.yaml`` builds YOLOv5-m
    (8 classes: 20.9 M parameters, 79 BatchNorms), on the CPU when asked;
    the default device raises without a card."""
    cfg = port_get_cfg()
    cfg.merge_from_file("configs/cityscapes/ALDI-Yolo-Cityscapes.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detector(cfg)
    det = build_detector(cfg, device="cpu")
    assert isinstance(det, yolo.YoloDetector)
    n_bn = sum(isinstance(m, yolo.BatchNorm) for m in det.module.modules())
    n_params = sum(p.numel() for p in det.module.parameters())
    print(f"YOLOv5-m: {n_params} parameters, {n_bn} BatchNorms")
    assert det.num_classes == 8 and det.dtype == torch.bfloat16
    assert n_bn == 79 and n_params == 20_899_605
    assert not any("num_batches_tracked" in k
                   for k in det.module.state_dict())
