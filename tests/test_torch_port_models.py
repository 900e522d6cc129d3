"""Port parity of the model stages (``aldi_tpu_torch/models`` against
``aldi_tpu/models``) at the tiny config, float32, on the CPU.

Both packages get the same seeded weights: the JAX detector's variable
tree filled from numpy, converted with ``jax_variables_to_state_dict``.
Every stage after the backbone gets the same inputs on both sides (the
JAX stage's outputs as numpy), so each comparison sees one stage's error.
The JAX side runs un-jitted. Tolerances: float32 convolutions and matrix
products sum in another order in each framework, about 1e-6 relative per
layer, so stage outputs are held to 1e-4 of their largest magnitude;
detections are compared only where ``valid`` is set, since top_k breaks
ties (and orders the -inf padding) differently in each framework.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models.rcnn import RCNN as JaxRCNN
from aldi_tpu.models.roi_heads import fast_rcnn_inference as jax_fri
from aldi_tpu.models.rpn import generate_proposals as jax_gp
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.models.rcnn import RCNN
from aldi_tpu_torch.models.roi_heads import fast_rcnn_inference
from aldi_tpu_torch.models.rpn import generate_proposals
from tests.torch_port_common import (max_err, seeded_variables,
                                     tiny_detectors, tiny_images)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

FLAGSHIP = "configs/cityscapes/ALDI-Best-Cityscapes.yaml"


@pytest.fixture(scope="module")
def dets():
    jdet, variables, tdet = tiny_detectors()
    images, sizes = tiny_images()
    x = np.array(jdet.preprocess(jnp.asarray(images)))
    jfeats = [np.array(f) for f in jdet.backbone(variables, jnp.asarray(x))]
    return jdet, variables, tdet, x, jfeats, sizes


def _close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = max_err(got, want)
    scale = float(np.max(np.abs(want), initial=1.0))
    print(f"{what}: max abs err {err:.3g} (scale {scale:.3g})")
    assert err <= rel * scale, what


def test_resnet26_fpn_matches_jax(dets):
    jdet, _, tdet, x, jfeats, _ = dets
    with torch.no_grad():
        feats = tdet.backbone(torch.from_numpy(x))
    assert len(feats) == len(jfeats) == 5
    for i, (g, w) in enumerate(zip(feats, jfeats)):
        _close(g.numpy(), w, what=f"p{i + 2}")


def test_rpn_head_matches_jax(dets):
    jdet, variables, tdet, _, jfeats, _ = dets
    jl, jd = jdet.rpn_head(variables, [jnp.asarray(f) for f in jfeats])
    with torch.no_grad():
        tl, td = tdet.rpn_head([torch.from_numpy(f) for f in jfeats])
    for i in range(5):
        _close(tl[i].numpy(), jl[i], what=f"objectness p{i + 2}")
        _close(td[i].numpy(), jd[i], what=f"anchor deltas p{i + 2}")


def test_generate_proposals_matches_jax(dets):
    jdet, variables, tdet, _, jfeats, sizes = dets
    jl, jd = jdet.rpn_head(variables, [jnp.asarray(f) for f in jfeats])
    want = [np.asarray(a) for a in jdet.proposals(jl, jd, jnp.asarray(sizes),
                                                  False)]
    got = [a.numpy() for a in tdet.proposals(
        [torch.from_numpy(np.array(a)) for a in jl],
        [torch.from_numpy(np.array(a)) for a in jd], torch.from_numpy(sizes))]
    np.testing.assert_array_equal(got[2], want[2])
    m = want[2]
    assert m.sum() > 0
    _close(got[0][m], want[0][m], rel=1e-6, what="proposal boxes")
    np.testing.assert_array_equal(got[1][m], want[1][m])


def test_box_head_matches_jax(dets):
    """Box pooler (the plain ROIAlign on the CPU), box head and predictor on
    the same features and boxes."""
    jdet, variables, tdet, _, jfeats, _ = dets
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (2, 16, 2))
    wh = rng.uniform(8, 120, (2, 16, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(0, 1, (2, 16)) > 0.2
    want = jdet.box_head(variables, [jnp.asarray(f) for f in jfeats],
                         jnp.asarray(boxes), jnp.asarray(valid),
                         pool_mode="corner_gather")
    with torch.no_grad():
        got = tdet.box_head([torch.from_numpy(f) for f in jfeats],
                            torch.from_numpy(boxes), torch.from_numpy(valid))
    for g, w, what in zip(got, want, ("cls logits", "deltas", "box feats")):
        _close(g.numpy(), w, what=what)


def test_fast_rcnn_inference_matches_jax():
    rng = np.random.default_rng(4)
    b, n, k = 2, 40, 3
    xy = rng.uniform(0, 100, (b, n, 2))
    wh = rng.uniform(5, 60, (b, n, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    pvalid = rng.uniform(0, 1, (b, n)) > 0.1
    logits = (rng.standard_normal((b, n, k + 1)) * 2).astype(np.float32)
    deltas = (rng.standard_normal((b, n, k * 4)) * 0.5).astype(np.float32)
    sizes = np.asarray([[120, 150], [90, 100]], np.int32)
    kw = dict(score_thresh=0.05, nms_thresh=0.5, topk_per_image=100)
    want = [np.asarray(a) for a in jax_fri(
        *(jnp.asarray(a) for a in (props, pvalid, logits, deltas, sizes)), k,
        **kw)]
    got = [a.numpy() for a in fast_rcnn_inference(
        *(torch.from_numpy(a) for a in (props, pvalid, logits, deltas, sizes)),
        k, **kw)]
    np.testing.assert_array_equal(got[3], want[3])
    m = want[3]
    assert 0 < m.sum() < m.size
    _close(got[0][m], want[0][m], rel=1e-6, what="detection boxes")
    _close(got[1][m], want[1][m], rel=1e-6, what="detection scores")
    np.testing.assert_array_equal(got[2][m], want[2][m])


def test_generate_proposals_pads_small_levels_like_jax():
    """A level with fewer anchors than pre_nms_topk is padded with -inf
    rows; the padded proposals stay invalid in both packages."""
    rng = np.random.default_rng(5)
    anchors = [np.concatenate([xy, xy + 20], -1).astype(np.float32)
               for xy in (rng.uniform(0, 60, (50, 2)), rng.uniform(0, 60, (6, 2)))]
    logits = [rng.standard_normal((2, len(a))).astype(np.float32)
              for a in anchors]
    deltas = [(rng.standard_normal((2, len(a), 4)) * 0.2).astype(np.float32)
              for a in anchors]
    sizes = np.asarray([[80, 80], [64, 70]], np.int32)
    kw = dict(pre_nms_topk=10, post_nms_topk=12, nms_thresh=0.7)
    want = [np.asarray(a) for a in jax_gp(
        [jnp.asarray(a) for a in logits], [jnp.asarray(a) for a in deltas],
        [jnp.asarray(a) for a in anchors], jnp.asarray(sizes), **kw)]
    got = [a.numpy() for a in generate_proposals(
        [torch.from_numpy(a) for a in logits],
        [torch.from_numpy(a) for a in deltas],
        [torch.from_numpy(a) for a in anchors], torch.from_numpy(sizes), **kw)]
    np.testing.assert_array_equal(got[2], want[2])
    m = want[2]
    _close(got[0][m], want[0][m], rel=1e-6, what="proposal boxes")


def test_full_width_state_dict_matches_jax_tree():
    """At the flagship's full width (R50-FPN, 8 classes) every JAX variable
    converts to exactly one entry of the port's state dict, of the same
    shape."""
    cfg = jax_get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    jdet = jax_build_detector(cfg)
    shapes = jax.eval_shape(
        lambda: JaxRCNN.init(jdet.module, jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 64, 3))))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(shapes))
    sd = jax_variables_to_state_dict(zeros)
    port = RCNN(num_classes=8, num_cell_anchors=3).state_dict()
    assert sorted(sd) == sorted(port)
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    n_params = sum(v.numel() for v in port.values())
    assert 40e6 < n_params < 45e6, n_params


def test_seeded_weights_load_strictly():
    jdet, _, tdet = tiny_detectors(seed=1)
    variables = seeded_variables(jdet, seed=2)
    missing = tdet.module.load_state_dict(
        jax_variables_to_state_dict(variables), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
