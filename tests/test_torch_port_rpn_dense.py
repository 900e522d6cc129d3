"""The dense RPN loss (``TPU.RPN_LOSS_IMPL="dense"``) of the port against
the JAX package, on the CPU: ``label_anchors`` and ``rpn_losses_dense``
(``aldi_tpu/models/rpn.py:64-152``) on the tiny canvas's 4092 anchors with
the JAX functions' own draws (``tests/torch_port_draws.py``
``label_anchors_dense_draws``), and one DAOD step of the tiny flagship
(``tests/test_torch_port_train_step.py``) with the dense loss against the
JAX package's jitted step.

Tolerances: labels and matched gt exactly; losses 1e-5 relative (the same
elementwise float32 terms, summed over the anchors in another order); the
step as ``test_torch_port_train_step.py`` holds it (losses 1e-4 relative,
parameters 1e-5 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models import rpn as jax_rpn
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import draw_step
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models import rpn as port_rpn
from aldi_tpu_torch.ops.match_kernel import low_quality_mask, match_iou
from tests import torch_port_draws as draws_from
from tests.test_torch_port_train_ops import canvas_anchors, close, random_boxes
from tests.test_torch_port_train_step import (_jax_steps, _port_steps,
                                              close_rel, daod_cfg, make_batch)
from tests.torch_port_common import max_err, seeded_variables
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

DENSE = {"TPU.RPN_LOSS_IMPL": "dense"}


def t(x):
    return torch.from_numpy(np.array(x))


def _case(seed, empty_image):
    """Gt [2, 8] with 5 and 2 valid boxes (or none in the second image),
    the RPN head's logits and deltas over the canvas's anchors."""
    rng = np.random.default_rng(seed)
    anchors = canvas_anchors()
    n = anchors.shape[0]
    gt = random_boxes(rng, (2, 8))
    valid = np.array([[1] * 5 + [0] * 3,
                      [0] * 8 if empty_image else [1] * 2 + [0] * 6], bool)
    logits = rng.standard_normal((2, n)).astype(np.float32)
    deltas = (rng.standard_normal((2, n, 4)) * 0.2).astype(np.float32)
    return anchors, gt, valid, logits, deltas


@pytest.mark.parametrize("empty_image", [False, True])
@pytest.mark.parametrize("bspi", [256, 32])
def test_label_anchors_and_dense_losses_match_jax(empty_image, bspi):
    anchors, gt, valid, logits, deltas = _case(7 + bspi, empty_image)
    n = anchors.shape[0]
    key = jax.random.PRNGKey(bspi + int(empty_image))
    d = draws_from.label_anchors_dense_draws(key, 2, n)
    want_lab, want_gt = jax_rpn.label_anchors(
        key, jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
        bspi, 0.5)
    for k in (match_iou, low_quality_mask):
        k.launches = 0
    lab, matched = port_rpn.label_anchors(t(anchors), t(gt), t(valid), d,
                                          bspi, 0.5)
    assert (match_iou.launches, low_quality_mask.launches) == (0, 0)
    assert lab.dtype == torch.int8
    np.testing.assert_array_equal(lab.numpy(), want_lab)
    np.testing.assert_array_equal(matched.numpy(), want_gt)
    counts = [(int((want_lab[i] == 1).sum()), int((want_lab[i] == 0).sum()))
              for i in range(2)]
    print(f"(positives, negatives) per image: {counts}")
    assert counts[0][0] > 0 and sum(counts[0]) == bspi
    want = jax_rpn.rpn_losses_dense(
        key, jnp.asarray(anchors), jnp.asarray(logits), jnp.asarray(deltas),
        jnp.asarray(gt), jnp.asarray(valid), bspi, 0.5)
    got = port_rpn.rpn_losses_dense(t(anchors), t(logits), t(deltas), t(gt),
                                    t(valid), d, bspi, 0.5)
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k in want:
        close(got[k].numpy(), want[k], rtol=1e-5, what=k)


def test_dense_and_sampled_losses_agree_when_saturated():
    """With every non-ignored anchor sampled the two forms compute the
    same sums (``aldi_tpu/models/rpn.py:132``: "same math")."""
    anchors, gt, valid, logits, deltas = _case(3, False)
    n = anchors.shape[0]
    gen = torch.Generator().manual_seed(0)
    from aldi_tpu_torch.ops.matcher import (subsample_indices_draws,
                                            subsample_labels_draws)
    dense = port_rpn.rpn_losses_dense(
        t(anchors), t(logits), t(deltas), t(gt), t(valid),
        subsample_labels_draws(gen, (2,), n), n, 1.0)
    sampled = port_rpn.rpn_losses(
        t(anchors), t(logits), t(deltas), t(gt), t(valid),
        subsample_indices_draws(gen, (2,), n, n, 1.0), n, 1.0)
    for k in dense:
        close(dense[k].numpy(), sampled[k].numpy(), rtol=1e-5, what=k)


def test_draw_step_gives_the_dense_loss_its_draws():
    """Per student stream, every anchor's keys for ``subsample_labels``;
    the teacher's distill anchors stay the sampled set's."""
    cfg = daod_cfg(port_get_cfg, **DENSE)
    det = build_detector(cfg, device="cpu")
    n = det.anchors_cat.shape[0]
    a = draw_step(torch.Generator().manual_seed(3), det, 2, 2)
    for stream in ("strong", "distill"):
        assert set(a[stream]["rpn"]) == {"pos_keys", "neg_keys"}
        assert a[stream]["rpn"]["pos_keys"].shape == (2, n)
    assert set(a["teacher"]) == {"pos_keys", "neg_keys", "tie"}


@pytest.fixture(scope="module")
def dense_step():
    """One DAOD step of both packages with the dense RPN loss (ROI
    sampling saturated; the RPN subsamples 256 of the 4092 anchors with
    the JAX step's draws)."""
    over = {**DENSE, "MODEL.RPN.BATCH_SIZE_PER_IMAGE": 256}
    jcfg = daod_cfg(jax_get_cfg, saturated=True, **over)
    tcfg = daod_cfg(port_get_cfg, saturated=True, **over)
    variables = seeded_variables(jax_build_detector(jcfg), seed=5)
    batch = make_batch(seed=2)
    rng = jax.random.PRNGKey(43)
    n_anchors = build_detector(tcfg, device="cpu").anchors_cat.shape[0]
    draws = draws_from.train_step_draws(rng, tcfg, 2, 2, n_anchors)
    return (_jax_steps(jcfg, variables, batch, [rng]),
            _port_steps(tcfg, variables, batch, [draws]),
            jax_variables_to_state_dict(variables))


def test_dense_daod_step_matches_jax(dense_step):
    (want_m, want_s, want_t), (got_m, state), start = dense_step
    assert set(got_m[0]) == set(want_m[0])
    assert {"loss_rpn_cls_source_strong", "loss_rpn_loc_distill"} <= set(
        want_m[0])
    for k in want_m[0]:
        close_rel(got_m[0][k], want_m[0][k], what=k)
    assert want_m[0]["num_pseudo_labels"] > 0
    got = dict(state.student.named_parameters())
    err = max(max_err(got[k].detach().numpy(), want_s[k].numpy())
              for k in want_s)
    moved = max(max_err(want_s[k].numpy(), start[k].numpy()) for k in want_s)
    print(f"student after the step: max abs err {err:.3g}, JAX's largest "
          f"move {moved:.3g}")
    assert err <= 1e-5 and moved >= 100 * 1e-5
