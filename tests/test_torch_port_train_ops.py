"""Port parity of the training ops (losses, matcher, samplers, proposal
sampling, Fast R-CNN losses, the ROIAlign gradient, strong augmentation,
EMA, pseudo-labels, distill losses, one SGD step) against the JAX package,
on the CPU.

Inputs are made with numpy from a seed; random draws come from JAX keys
through ``tests/torch_port_draws.py``, so both packages sample the same
sets. Tolerances: elementwise float32 arithmetic done in the same order in
both packages, a few ulps (rtol 1e-6); sums taken in another order (the
ROIAlign gradient's scatter-adds, the blur's image-wide mean, the optimizer
update), 1e-5 relative to the values' scale; the strong views, on the
0..255 scale, 1e-3; indices, labels and masks are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.data import strong_aug as jax_aug
from aldi_tpu.engine import distill as jax_distill
from aldi_tpu.engine.ema import ema_update as jax_ema_update
from aldi_tpu.engine.pseudolabel import detections_to_pseudo_labels as jax_pl
from aldi_tpu.models import roi_heads as jax_roi_heads
from aldi_tpu.models import rpn as jax_rpn
from aldi_tpu.ops import boxes as jax_boxes
from aldi_tpu.ops import losses as jax_losses
from aldi_tpu.ops import matcher as jax_matcher
from aldi_tpu.ops import pallas_match
from aldi_tpu.ops import roi_align as jax_roi
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.data import strong_aug as port_aug
from aldi_tpu_torch.engine import distill as port_distill
from aldi_tpu_torch.engine.ema import ema_update
from aldi_tpu_torch.engine.pseudolabel import detections_to_pseudo_labels
from aldi_tpu_torch.models import roi_heads as port_roi_heads
from aldi_tpu_torch.models import rpn as port_rpn
from aldi_tpu_torch.ops import losses as port_losses
from aldi_tpu_torch.ops import match_kernel
from aldi_tpu_torch.ops import matcher as port_matcher
from aldi_tpu_torch.ops.anchors import AnchorGenerator
from aldi_tpu_torch.ops.roi_align import box_levels, roi_align_batched
from aldi_tpu_torch.solver import (build_lr_schedule, build_optimizer,
                                   clip_gradients, set_lr)
from tests import torch_port_draws as draws_from
from tests.torch_port_common import max_err
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

STRIDES = [4, 8, 16, 32]


def t(x):
    return torch.from_numpy(np.array(x))


def random_boxes(rng, shape, size=128.0, lo=4.0, hi=60.0):
    xy = rng.uniform(0, size - lo, shape + (2,))
    wh = rng.uniform(lo, hi, shape + (2,))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def canvas_anchors(canvas=(128, 128)):
    """The tiny canvas's 4092 anchors, all levels concatenated."""
    cfg = port_get_cfg()
    strides = [4, 8, 16, 32, 64]
    hws = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in strides]
    return np.concatenate(AnchorGenerator.from_config(cfg, strides)(hws))


def close(got, want, rtol=1e-6, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = max_err(got, want)
    scale = float(np.max(np.abs(want), initial=1.0))
    print(f"{what}: max abs err {err:.3g} (scale {scale:.3g})")
    assert err <= rtol * scale, what


# ---------------------------------------------------------------- losses
def _loss_inputs():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    return (logits, rng.uniform(0, 1, (6, 5)).astype(np.float32),
            rng.integers(0, 5, (6,)).astype(np.int32),
            rng.uniform(0, 1, (6,)) > 0.4)


LOSSES = {
    "smooth_l1_l1": lambda m, x, p, c, k: m.smooth_l1(x, p * 4, 0.0),
    "smooth_l1_huber": lambda m, x, p, c, k: m.smooth_l1(x, p * 4, 0.5),
    "bce_with_logits": lambda m, x, p, c, k: m.bce_with_logits(x, p),
    "softmax_ce_labels": lambda m, x, p, c, k: m.softmax_cross_entropy(x, c),
    "softmax_ce_soft": lambda m, x, p, c, k: m.softmax_cross_entropy(
        x, p / p.sum(-1, keepdims=True)),
    "kl_div_log_targets": lambda m, x, p, c, k: m.kl_div_log_targets(
        x - x.max(), p - 2.0),
    "masked_mean": lambda m, x, p, c, k: m.masked_mean(x[:, 0], k),
    "masked_mean_empty": lambda m, x, p, c, k: m.masked_mean(x[:, 0], k & ~k),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    args = _loss_inputs()
    want = LOSSES[name](jax_losses, *(jnp.asarray(a) for a in args))
    got = LOSSES[name](port_losses, *(t(a) for a in args))
    close(got.numpy(), want, what=name)


# --------------------------------------------------------------- matcher
def _match_case(valid_pattern):
    rng = np.random.default_rng(1)
    anchors = canvas_anchors()
    gt = random_boxes(rng, (2, 8))
    valid = np.array(valid_pattern, bool)
    return anchors, gt, valid


@pytest.mark.parametrize("pattern", [
    [[1, 1, 1, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1, 0, 1]],
    [[0] * 8, [1] + [0] * 7],  # no valid gt in one image
])
def test_match_boxes_plain_matches_jax_and_pallas(pattern):
    """The port's batched matcher against ``matcher.match`` and the Pallas
    kernels in interpret mode, image by image: idx and labels exact."""
    anchors, gt, valid = _match_case(pattern)
    idx, lab = match_kernel.match_boxes(
        t(anchors), t(gt), t(valid), [0.3, 0.7], [0, -1, 1], True)
    for b in range(2):
        iou = jax_boxes.pairwise_iou(jnp.asarray(anchors), jnp.asarray(gt[b]))
        want_idx, want_lab = jax_matcher.match(
            iou, jnp.asarray(valid[b]), [0.3, 0.7], [0, -1, 1], True)
        np.testing.assert_array_equal(idx[b].numpy(), want_idx)
        np.testing.assert_array_equal(lab[b].numpy(), want_lab)
        p_idx, p_lab = pallas_match.match_boxes_pallas(
            jnp.asarray(anchors), jnp.asarray(gt[b]), jnp.asarray(valid[b]),
            [0.3, 0.7], [0, -1, 1], allow_low_quality=True, interpret=True)
        np.testing.assert_array_equal(idx[b].numpy(), p_idx)
        np.testing.assert_array_equal(lab[b].numpy(), p_lab)
    assert (lab.numpy() == 1).any()


def test_kernel_plain_versions_match_pallas():
    """The plain versions of K1a and K1b against the Pallas kernels in
    interpret mode: vals and per-gt best to float32 rounding, idx and the
    low-quality mask exact."""
    anchors, gt, valid = _match_case([[1, 0, 1, 1, 0, 1, 1, 1],
                                      [1, 1, 1, 1, 1, 1, 1, 1]])
    vals, idx, best = match_kernel.match_iou_plain(t(anchors), t(gt),
                                                   t(valid))
    lowq = match_kernel.low_quality_mask_plain(t(anchors), t(gt), t(valid),
                                               best)
    for b in range(2):
        args = (jnp.asarray(anchors), jnp.asarray(gt[b]),
                jnp.asarray(valid[b]))
        w_vals, w_idx, w_best = pallas_match.match_iou_pallas(
            *args, interpret=True)
        close(vals[b].numpy(), w_vals, what="vals")
        close(best[b].numpy(), w_best, what="best")
        np.testing.assert_array_equal(idx[b].numpy(), w_idx)
        w_lowq = pallas_match.low_quality_mask_pallas(*args, w_best,
                                                      interpret=True)
        np.testing.assert_array_equal(lowq[b].numpy(), w_lowq)


# -------------------------------------------------------------- samplers
def test_topk_smallest_with_idx_matches_jax():
    """Integer keys with many ties, long enough for the JAX package's
    segmented path: the same values and the same (lowest-first) indices."""
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 50, (10000,)).astype(np.int32)
    want_v, want_i = jax_matcher.topk_smallest_with_idx(jnp.asarray(vals), 300)
    got_v, got_i = port_matcher.topk_smallest_with_idx(t(vals), 300)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("n,num_samples,frac", [
    (10000, 256, 0.5),  # the segmented path of the JAX package
    (300, 128, 0.25),
    (50, 64, 0.5),  # fewer candidates than samples: an invalid tail
])
def test_subsample_indices_matches_jax(n, num_samples, frac):
    rng = np.random.default_rng(3)
    labels = rng.choice([-1, 0, 1], size=(2, n), p=[0.2, 0.75, 0.05])
    labels = labels.astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    d = [draws_from.subsample_indices_draws(k, n, num_samples, frac)
         for k in keys]
    d = {k: torch.stack([x[k] for x in d]) for k in d[0]}
    idx, ok, pos = port_matcher.subsample_indices(t(labels), num_samples,
                                                  frac, 0, d)
    for b in range(2):
        w = jax_matcher.subsample_indices(keys[b], jnp.asarray(labels[b]),
                                          num_samples, frac, bg_label=0)
        np.testing.assert_array_equal(ok[b].numpy(), w[1])
        np.testing.assert_array_equal(pos[b].numpy(), w[2])
        m = np.asarray(w[1])
        np.testing.assert_array_equal(idx[b].numpy()[m], np.asarray(w[0])[m])
    assert ok.any() and pos.any()


def test_subsample_labels_and_fixed_indices_match_jax():
    rng = np.random.default_rng(5)
    n, k = 200, 48
    labels = rng.choice([-1, 0, 1, 2], size=(n,), p=[0.1, 0.6, 0.2, 0.1])
    labels = labels.astype(np.int32)
    key = jax.random.PRNGKey(6)
    k_sub, k_idx = jax.random.split(key)
    want_pos, want_neg = jax_matcher.subsample_labels(
        k_sub, jnp.asarray(labels), k, 0.25, bg_label=0)
    d = draws_from.subsample_labels_draws(k_sub, n)
    pos, neg = port_matcher.subsample_labels(t(labels), k, 0.25, 0, d)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(neg.numpy(), want_neg)
    want = jax_matcher.sample_fixed_indices(k_idx, want_pos, want_neg, k)
    fill = t(jax.random.uniform(k_idx, (n,)))
    got = port_matcher.sample_fixed_indices(pos, neg, k, fill)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_label_anchors_and_rpn_losses_match_jax():
    rng = np.random.default_rng(7)
    anchors = canvas_anchors()
    n = anchors.shape[0]
    gt = random_boxes(rng, (2, 8))
    valid = np.array([[1] * 5 + [0] * 3, [1] * 2 + [0] * 6], bool)
    logits = rng.standard_normal((2, n)).astype(np.float32)
    deltas = (rng.standard_normal((2, n, 4)) * 0.2).astype(np.float32)
    key = jax.random.PRNGKey(8)
    d = draws_from.label_anchors_draws(key, 2, n, 256, 0.5)
    want = jax_rpn.label_anchors_sampled(
        key, jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid), 256,
        0.5)
    got = port_rpn.label_anchors_sampled(t(anchors), t(gt), t(valid), d, 256,
                                         0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    want_l = jax_rpn.rpn_losses(key, jnp.asarray(anchors),
                                jnp.asarray(logits), jnp.asarray(deltas),
                                jnp.asarray(gt), jnp.asarray(valid))
    got_l = port_rpn.rpn_losses(t(anchors), t(logits), t(deltas), t(gt),
                                t(valid), d)
    for k in want_l:
        close(got_l[k].numpy(), want_l[k], what=k)


def test_sample_proposals_and_fast_rcnn_losses_match_jax():
    rng = np.random.default_rng(9)
    b, n, g, k, nc = 2, 32, 8, 16, 3
    props = random_boxes(rng, (b, n))
    pvalid = rng.uniform(0, 1, (b, n)) > 0.1
    gt = random_boxes(rng, (b, g))
    gcls = rng.integers(0, nc, (b, g)).astype(np.int32)
    gvalid = np.array([[1] * 4 + [0] * 4, [1] * 6 + [0] * 2], bool)
    # half of the proposals near a gt box, so there are positives
    props[:, : n // 2] = gt[:, rng.integers(0, 4, n // 2)] + rng.uniform(
        -3, 3, (b, n // 2, 4)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    params = dict(num_classes=nc, batch_size_per_image=k,
                  positive_fraction=0.25, iou_threshold=0.5, append_gt=True)
    want = jax_roi_heads.sample_proposals(
        key, jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt),
        jnp.asarray(gcls), jnp.asarray(gvalid), **params)
    d = draws_from.sample_proposals_draws(key, b, n + g)
    got = port_roi_heads.sample_proposals(t(props), t(pvalid), t(gt),
                                          t(gcls), t(gvalid), d, **params)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name], name)
    assert got["is_pos"].any()

    cls_logits = rng.standard_normal((b, k, nc + 1)).astype(np.float32)
    deltas = (rng.standard_normal((b, k, nc * 4)) * 0.3).astype(np.float32)
    want_l = jax_roi_heads.fast_rcnn_losses(
        jnp.asarray(cls_logits), jnp.asarray(deltas), want, nc)
    got_l = port_roi_heads.fast_rcnn_losses(t(cls_logits), t(deltas), got, nc)
    for name in want_l:
        close(got_l[name].numpy(), want_l[name], what=name)


# ------------------------------------------------------ ROIAlign gradient
def test_roi_align_gradient_matches_jax():
    """``roi_align_batched``'s autograd function (the plain backward on the
    CPU) against ``jax.grad`` of the corner-gather ROIAlign, float32."""
    rng = np.random.default_rng(11)
    b, p, c, canvas = 2, 24, 16, (96, 160)
    feats = [rng.standard_normal((b, -(-canvas[0] // s), -(-canvas[1] // s),
                                  c)).astype(np.float32) for s in STRIDES]
    side = np.exp(rng.uniform(np.log(8), np.log(700), (b, p)))
    cx = rng.uniform(-10, canvas[1] + 10, (b, p))
    cy = rng.uniform(-10, canvas[0] + 10, (b, p))
    boxes = np.stack([cx - side / 2, cy - side / 3, cx + side / 2,
                      cy + side / 3], -1).astype(np.float32)
    valid = rng.uniform(0, 1, (b, p)) > 0.2
    cot = rng.standard_normal((b, p, 7, 7, c)).astype(np.float32)

    def f(fs):
        out = jax_roi.roi_align_batched(fs, jnp.asarray(boxes),
                                        jnp.asarray(valid), STRIDES,
                                        mode="corner_gather")
        return (out * cot).sum()

    want = jax.grad(f)([jnp.asarray(x) for x in feats])
    ft = [t(x).requires_grad_(True) for x in feats]
    out = roi_align_batched(ft, t(boxes), t(valid), STRIDES)
    (out * t(cot)).sum().backward()
    levels = box_levels(t(boxes), t(valid), STRIDES)
    assert all((levels == lv).any() for lv in range(4))  # every level used
    for i, (g, w) in enumerate(zip(ft, want)):
        close(g.grad.numpy(), w, rtol=1e-5, what=f"d p{i + 2}")


def test_roi_align_plain_backward_bfloat16_accumulates_in_float32():
    """bfloat16 features: the gradient is the float32 one cast once (one
    bf16 rounding), not a sum of bfloat16 partial sums."""
    rng = np.random.default_rng(12)
    feats = [rng.standard_normal((1, 24 // s * 4, 40 // s * 4, 8)).astype(
        np.float32) for s in (1, 2, 4, 8)]
    boxes = t(random_boxes(rng, (1, 40), size=80, lo=8, hi=200))
    valid = torch.ones((1, 40), dtype=torch.bool)
    # a cotangent that bfloat16 holds exactly, so both runs get the same
    cot = t(rng.standard_normal((1, 40, 7, 7, 8)).astype(np.float32)).to(
        torch.bfloat16).float()
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        ft = [t(x).to(dt).requires_grad_(True) for x in feats]
        (roi_align_batched(ft, boxes, valid, STRIDES).float()
         * cot).sum().backward()
        grads[dt] = [f.grad for f in ft]
    for g16, g32 in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert g16.dtype == torch.bfloat16
        np.testing.assert_array_equal(g16.float().numpy(),
                                      g32.to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------- strong views
@pytest.mark.parametrize("erase,mic", [(True, False), (False, True)])
def test_strong_augment_matches_jax(erase, mic):
    rng = np.random.default_rng(13)
    b, canvas = 4, (64, 96)
    images = rng.uniform(0, 255, (b, *canvas, 3)).astype(np.float32)
    sizes = np.array([[64, 96], [50, 90], [64, 70], [40, 40]], np.int32)
    key = jax.random.PRNGKey(16)  # every Bernoulli both ways in the batch
    want = jax_aug.strong_augment(key, jnp.asarray(images),
                                  jnp.asarray(sizes), include_erasing=erase,
                                  mic=mic, mic_ratio=0.5, mic_block_size=16)
    d = draws_from.strong_aug_draws(key, b, canvas, erase, mic, 16)
    got = port_aug.strong_augment(t(images), t(sizes), d, erase, mic, 0.5)
    err = max_err(got.numpy(), want)
    print(f"strong_augment: max abs err {err:.3g} (0..255 scale)")
    assert err <= 1e-3
    for name in ("do_blur", "do_jitter", "do_gray"):
        assert d[name].any() and not d[name].all(), name


# ------------------------------------------- EMA, pseudo-labels, distill
def test_ema_update_matches_jax():
    rng = np.random.default_rng(15)
    shapes = {"a": (3, 4), "query_embed": (5,), "b": (7,)}
    s_np = {k: rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}
    e_np = {k: rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}

    def module(values):
        m = torch.nn.Module()
        for k, v in values.items():
            m.register_parameter(k, torch.nn.Parameter(t(v)))
        return m

    stats_s = rng.standard_normal(6).astype(np.float32)
    stats_e = rng.standard_normal(6).astype(np.float32)
    for step in (0, 5):
        want = jax_ema_update({k: jnp.asarray(v) for k, v in e_np.items()},
                              {k: jnp.asarray(v) for k, v in s_np.items()},
                              0.9996, step, start_iter=0)
        # a floating buffer (YOLO's running statistics, the JAX state's
        # model_state) is blended like a parameter; a buffer the teacher
        # shares with the student (FrozenBN) stays bitwise as it is
        want_stats = jax_ema_update({"s": jnp.asarray(stats_e)},
                                    {"s": jnp.asarray(stats_s)}, 0.9996,
                                    step, start_iter=0)["s"]
        teacher, student = module(e_np), module(s_np)
        teacher.register_buffer("stats", t(stats_e))
        student.register_buffer("stats", t(stats_s))
        shared = t(stats_s * 3)
        teacher.register_buffer("frozen", shared)
        student.register_buffer("frozen", shared)
        ema_update(teacher, student, 0.9996, step, start_iter=0)
        for k in shapes:
            close(getattr(teacher, k).detach().numpy(), want[k],
                  what=f"ema step {step} {k}")
        close(teacher.stats.numpy(), want_stats, what=f"ema step {step} stats")
        assert teacher.frozen is shared
        assert torch.equal(shared, t(stats_s * 3))


def test_pseudo_labels_match_jax():
    rng = np.random.default_rng(16)
    for d in (5, 12):  # padded and trimmed to max_gt=8
        boxes = random_boxes(rng, (2, d))
        scores = np.sort(rng.uniform(0, 1, (2, d)), 1)[:, ::-1].astype(
            np.float32)
        classes = rng.integers(0, 3, (2, d)).astype(np.int32)
        valid = rng.uniform(0, 1, (2, d)) > 0.2
        want = jax_pl(*(jnp.asarray(x) for x in (boxes, scores, classes,
                                                 valid)), 0.4, 8)
        got = detections_to_pseudo_labels(
            *(t(x) for x in (boxes, scores, classes, valid)), 0.4, 8)
        for name in ("boxes", "classes", "valid", "scores"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name), name)


@pytest.mark.parametrize("loss_type", ["CE", "KL"])
def test_distill_losses_match_jax(loss_type):
    rng = np.random.default_rng(17)
    b, k, s, nc = 2, 40, 16, 3
    arr = {
        "s_obj": rng.standard_normal((b, k)), "t_obj": rng.standard_normal(
            (b, k)),
        "s_d": rng.standard_normal((b, k, 4)), "t_d": rng.standard_normal(
            (b, k, 4)),
        "s_cls": rng.standard_normal((b, s, nc + 1)) * 2,
        "t_cls": rng.standard_normal((b, s, nc + 1)) * 2,
        "s_rd": rng.standard_normal((b, s, nc * 4)),
        "t_rd": rng.standard_normal((b, s, nc * 4)),
    }
    arr = {n: v.astype(np.float32) for n, v in arr.items()}
    valid = rng.uniform(0, 1, (b, k)) > 0.3
    fg = valid & (rng.uniform(0, 1, (b, k)) > 0.7)
    svalid = rng.uniform(0, 1, (b, s)) > 0.2

    def run(m, conv):
        out = m.rpn_distill_losses(conv(arr["s_obj"]), conv(arr["s_d"]),
                                   conv(arr["t_obj"]), conv(arr["t_d"]),
                                   conv(valid), conv(fg), obj_temperature=2.0)
        out.update(m.roih_distill_losses(
            conv(arr["s_cls"]), conv(arr["s_rd"]), conv(arr["t_cls"]),
            conv(arr["t_rd"]), conv(svalid), nc, cls_temperature=1.5,
            cls_loss_type=loss_type))
        return out

    want = run(jax_distill, jnp.asarray)
    got = run(port_distill, t)
    assert set(got) == set(want)
    for name in want:
        close(got[name].numpy(), want[name], what=name)


def test_gate_hard_losses_matches_jax():
    losses = {"loss_cls": 1.5, "loss_rpn_cls": 2.0, "loss_rpn_loc": 0.5,
              "loss_box_reg": 0.25}
    for flags in ((False, False, False, False), (True, False, True, False)):
        jcfg, pcfg = jax_get_cfg(), port_get_cfg()
        for cfg in (jcfg, pcfg):
            d = cfg.DOMAIN_ADAPT.DISTILL
            (d.HARD_ROIH_CLS_ENABLED, d.HARD_OBJ_ENABLED,
             d.HARD_RPN_REG_ENABLED, d.HARD_ROIH_REG_ENABLED) = flags
        want = jax_distill.gate_hard_losses(
            {k: jnp.asarray(v) for k, v in losses.items()}, jcfg)
        got = port_distill.gate_hard_losses(
            {k: torch.tensor(v) for k, v in losses.items()}, pcfg)
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}


# ------------------------------------------------------------- optimizer
def test_sgd_steps_match_optax():
    """Two SGD steps (momentum, weight decay, warmup, clipping by global
    norm, a frozen stem) against the JAX package's optax optimizer."""
    rng = np.random.default_rng(18)
    shapes = {("backbone", "stem_conv1"): (4, 3), ("backbone", "res3_block0"):
              (6,), ("box_predictor", "cls_score"): (5, 2)}
    values = {k: rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    grads = [{k: (rng.standard_normal(v) * 3).astype(np.float32)
              for k, v in shapes.items()} for _ in range(2)]
    for g in grads:
        g[("backbone", "stem_conv1")][:] = 0.0  # frozen: no gradient
    cfgs = []
    for get_cfg in (jax_get_cfg, port_get_cfg):
        cfg = get_cfg()
        cfg.SOLVER.BASE_LR = 0.02
        cfg.SOLVER.WARMUP_ITERS = 10
        cfg.SOLVER.WEIGHT_DECAY = 1e-3
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
        cfgs.append(cfg)

    def tree(flat):
        out = {}
        for (top, mod), v in flat.items():
            out.setdefault(top, {}).setdefault(mod, {})["kernel"] = \
                jnp.asarray(v)
        return out

    params = tree(values)
    tx = jax_build_optimizer(cfgs[0], params)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(tree(g), opt_state, params)
        params = optax.apply_updates(params, updates)

    module = torch.nn.Module()
    names = {k: "_".join(k) for k in shapes}
    for k, v in values.items():
        module.register_parameter(names[k], torch.nn.Parameter(t(v)))
    getattr(module, names[("backbone", "stem_conv1")]).requires_grad_(False)
    opt = build_optimizer(cfgs[1], module)
    schedule = build_lr_schedule(cfgs[1])
    trainable = [p for p in module.parameters() if p.requires_grad]
    for step, g in enumerate(grads):
        for k in shapes:
            p = getattr(module, names[k])
            if p.requires_grad:
                p.grad = t(g[k])
        clip_gradients(cfgs[1], trainable)
        set_lr(opt, schedule(step))
        opt.step()
    for k in shapes:
        close(getattr(module, names[k]).detach().numpy(),
              params[k[0]][k[1]]["kernel"], rtol=1e-5, what="/".join(k))
