"""Fast R-CNN on precomputed proposals (``MODEL.LOAD_PROPOSALS``) in the port
against the JAX package, on the CPU.

The tiny config is the flagship's of ``tests/test_torch_port_train_step.py``
(ResNet-26, canvas 128, 3 classes, float32) made supervised
(``labeled_strong`` only) with top-k 24 proposals in training and 16 at
test, as ``tests/test_proposals.py`` sizes them. Proposal files are written
in detectron2's pickle format from the records' gt: the gt, jittered gt and
random boxes with objectness logits (``tests/test_proposals.py:81-118``).

Tolerances: proposal transforms, records, loader batches and rejections
exactly; ``forward_train`` losses 1e-4 relative and gradients 1e-4 of each
tensor's largest magnitude (``test_torch_port_train_step.py``);
``forward_inference`` boxes 1e-3 px and scores 1e-5 where valid; the
trainer's AP 1e-6 against the JAX evaluator on the port's trained weights;
world 2 against world 1 as ``tests/test_torch_port_ddp.py`` holds them
(losses 1e-4 relative, parameters 1e-4).
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aldi_tpu.engine.evaluator as jax_evaluator
from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.data import catalog as jax_catalog
from aldi_tpu.data import proposals as jax_proposals
from aldi_tpu.data.loader import StreamLoader as JaxStreamLoader
from aldi_tpu.data.loader import TestLoader as JaxTestLoader
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.engine.checkpoint_convert import torch_state_dict_to_tree
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.structures import Instances as JaxInstances
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.data import proposals as port_proposals
from aldi_tpu_torch.data.loader import StreamLoader, TestLoader
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import draw_step, make_train_step
from aldi_tpu_torch.engine.trainer import ALDITrainer
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd, roi_align_fwd
from aldi_tpu_torch.structures import Instances
from aldi_tpu_torch.utils import events
from tests import torch_port_dist as dist_run
from tests import torch_port_draws as draws_from
from tests.test_torch_port_ddp import check_metrics, check_params, rank_sums
from tests.test_torch_port_train_step import (_jax_steps, _port_steps,
                                              close_rel, daod_cfg, make_batch,
                                              torch_tree)
from tests.torch_port_common import (DECODERS, decoder_branch,
                                     drop_weight_files, loader_cfg, max_err,
                                     port_state_as_reference,
                                     register_synthetic_both,
                                     seeded_variables, tiny_detectors,
                                     tiny_images)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

TOPK_TRAIN, TOPK_TEST = 24, 16


def fast_rcnn_cfg(get_cfg, **overrides):
    """The tiny flagship, supervised, on precomputed proposals."""
    cfg = daod_cfg(get_cfg, **overrides)
    cfg.MODEL.LOAD_PROPOSALS = True
    cfg.DATASETS.BATCH_CONTENTS = ("labeled_strong",)
    cfg.DATASETS.BATCH_RATIOS = (1,)
    cfg.DATASETS.UNLABELED = ()
    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = TOPK_TRAIN
    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = TOPK_TEST
    return cfg


def proposal_arrays(gt_boxes, n, canvas, rng):
    """[n, 4] proposals (the gt jittered by 2 px, then random boxes) and
    their objectness logits, as a proposal file holds one image's."""
    gt = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    jit = gt + rng.normal(0, 2.0, gt.shape).astype(np.float32)
    h, w = canvas
    m = max(n - len(gt), 0)
    neg = np.stack([rng.uniform(0, w * 0.6, m), rng.uniform(0, h * 0.6, m),
                    rng.uniform(w * 0.4, w, m), rng.uniform(h * 0.4, h, m)],
                   axis=1).astype(np.float32)
    boxes = np.concatenate([jit, neg])[:n]
    logits = np.concatenate([np.full(len(jit), 2.0, np.float32),
                             rng.normal(-1, 0.5, m).astype(np.float32)])[:n]
    return boxes, logits


def write_proposal_file(records, path, seed=0):
    """Each record's gt (logit 4), the gt jittered by 2 px (logit 2) and
    12 random boxes (``tests/test_proposals.py:81-118``), in detectron2's
    format."""
    rng = np.random.default_rng(seed)
    ids, boxes, logits = [], [], []
    for r in records:
        xyxy = np.array([a["bbox"] for a in r["annotations"]],
                        np.float32).reshape(-1, 4)
        xyxy[:, 2:] += xyxy[:, :2]
        jit = xyxy + rng.normal(0, 2.0, xyxy.shape).astype(np.float32)
        w, h = r["width"], r["height"]
        neg = np.stack([rng.uniform(0, w * 0.6, 12),
                        rng.uniform(0, h * 0.6, 12),
                        rng.uniform(w * 0.4, w, 12),
                        rng.uniform(h * 0.4, h, 12)], 1).astype(np.float32)
        ids.append(r["image_id"])
        boxes.append(np.concatenate([xyxy, jit, neg]))
        logits.append(np.concatenate([
            np.full(len(xyxy), 4.0, np.float32),
            np.full(len(jit), 2.0, np.float32),
            rng.normal(-1, 0.5, 12).astype(np.float32)]))
    with open(path, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes, "objectness_logits": logits,
                     "bbox_mode": 0}, f)


def with_proposals(batch, seed=0, k=TOPK_TRAIN):
    """``make_batch``'s batch with ``pboxes``/``pvalid`` [B, k] around its
    gt (the last 3 slots of each image invalid)."""
    rng = np.random.default_rng(seed)
    lab = batch["labeled"]
    b = lab["image"].shape[0]
    pb = np.zeros((b, k, 4), np.float32)
    for i in range(b):
        pb[i] = proposal_arrays(lab["boxes"][i][lab["valid"][i]], k,
                                (128, 128), rng)[0]
    pb = np.clip(pb, 0, 128)
    pv = np.ones((b, k), bool)
    pv[:, -3:] = False
    lab["pboxes"], lab["pvalid"] = pb, pv
    return batch


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The trainer's writers without TensorBoard (its first write imports
    TensorFlow here)."""
    def unavailable(*args):
        raise ImportError("TensorBoard left out of the tests")

    monkeypatch.setattr(events, "TensorBoardWriter", unavailable)


# ------------------------------------------------------- data, exactly
@pytest.mark.parametrize("case", [
    dict(scale=2.0, do_flip=True, out_w=64, out_h=48, topk=4),
    dict(scale=0.75, do_flip=False, out_w=96, out_h=72, topk=40),
    dict(scale=1.0, do_flip=True, out_w=15, out_h=15, topk=8,
         crop_offset=(8, 8), crop_wh=(15, 15)),
    dict(scale=1.5, do_flip=False, out_w=120, out_h=90, topk=16,
         crop_offset=(20, 5), crop_wh=(80, 60)),
], ids=["scale-flip-topk", "pad", "crop-flip", "crop-scale"])
def test_transform_proposals_equals_jax(case):
    rng = np.random.default_rng(len(str(case)))
    xy = rng.uniform(-10, 100, (30, 2))
    wh = rng.uniform(0.1, 40, (30, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    logits = np.round(rng.normal(0, 1, 30), 1).astype(np.float32)  # ties
    got = port_proposals.transform_proposals(boxes, logits, **case)
    want = jax_proposals.transform_proposals(boxes, logits, **case)
    print(f"{case}: {int(want[2].sum())} valid of {case['topk']}")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_load_proposals_and_files_equal_jax(tmp_path):
    pf = os.path.join(str(tmp_path), "p.pkl")
    with open(pf, "wb") as f:
        pickle.dump({"ids": [1, "3"],
                     "boxes": [np.array([[0, 0, 5, 5]], np.float32),
                               np.zeros((2, 4), np.float64)],
                     "objectness_logits": [np.array([1.0]), np.zeros(2)],
                     "bbox_mode": 0}, f)
    recs = [{"image_id": 1}, {"image_id": 2}, {"image_id": 3}]
    got = port_proposals.load_proposals_into_dataset(recs, pf)
    want = jax_proposals.load_proposals_into_dataset(recs, pf)
    assert "proposal_boxes" not in recs[0]  # the catalog's records stay
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("proposal_boxes", "proposal_objectness_logits"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got[1]["proposal_boxes"].shape == (0, 4)
    for train in (True, False):
        for on, files in ((True, ("a.pkl", "b.pkl")), (False, ("a.pkl",
                                                               "b.pkl")),
                          (True, ())):
            cfgs = []
            for get_cfg in (jax_get_cfg, port_get_cfg):
                cfg = get_cfg()
                cfg.MODEL.LOAD_PROPOSALS = on
                cfg.DATASETS.PROPOSAL_FILES_TRAIN = files
                cfg.DATASETS.PROPOSAL_FILES_TEST = files
                cfgs.append(cfg)
            assert port_proposals.proposal_files_for(
                cfgs[1], ("x", "y"), train) == jax_proposals.proposal_files_for(
                cfgs[0], ("x", "y"), train)
    cfg = port_get_cfg()
    cfg.MODEL.LOAD_PROPOSALS = True
    cfg.DATASETS.PROPOSAL_FILES_TRAIN = ("a.pkl", "b.pkl")
    with pytest.raises(ValueError, match="align 1:1"):
        port_proposals.proposal_files_for(cfg, ("x",), True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic splits in both catalogs and a proposal file for each."""
    root = tmp_path_factory.mktemp("data")
    names = register_synthetic_both(root, "port_props")
    files = {}
    for split, seed in (("train", 0), ("val", 1)):
        files[split] = os.path.join(str(root), f"props_{split}.pkl")
        write_proposal_file(jax_catalog.DatasetCatalog.get(names[split]),
                            files[split], seed)
    return names, files


def data_cfg(get_cfg, names, files, out="", **overrides):
    cfg = loader_cfg(fast_rcnn_cfg(get_cfg, **overrides), names)
    cfg.DATASETS.PROPOSAL_FILES_TRAIN = (files["train"],)
    cfg.DATASETS.PROPOSAL_FILES_TEST = (files["val"],)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.DEVICE = "cpu"
    cfg.OUTPUT_DIR = str(out)
    return cfg


@pytest.mark.parametrize("branch", DECODERS)
@pytest.mark.parametrize("crop", [False, True])
def test_loader_batches_carry_proposals_as_jax(data, monkeypatch, crop,
                                              branch):
    """The training loader's batches (with the same drawn choice for the
    image, its gt and its proposals; with RandomCrop too) and the test
    loader's, key for key; and a rank's share of a global batch under
    data parallelism keeps its images' proposals."""
    decoder_branch(monkeypatch, branch)
    names, files = data
    over = {"INPUT.CROP.ENABLED": crop, "INPUT.CROP.TYPE": "relative_range",
            "INPUT.CROP.SIZE": [0.6, 0.7]}
    cfgs = [data_cfg(g, names, files, **over)
            for g in (jax_get_cfg, port_get_cfg)]

    def records(pkg_cfg, get_records):
        return get_records(pkg_cfg.DATASETS.TRAIN, True, [files["train"]])

    from aldi_tpu.data.loader import get_dataset_records as jax_records
    from aldi_tpu_torch.data.loader import get_dataset_records

    want_l = JaxStreamLoader(records(cfgs[0], jax_records), 4, cfgs[0],
                             (128, 128), seed=3, num_threads=1)
    got_l = StreamLoader(records(cfgs[1], get_dataset_records), 4, cfgs[1],
                         (128, 128), seed=3, num_threads=1)
    halves = [StreamLoader(records(cfgs[1], get_dataset_records), 4, cfgs[1],
                           (128, 128), seed=3, num_threads=1,
                           shard=(r, 2, 1)) for r in range(2)]
    for idx in (0, 1):
        want, got = want_l._make_batch(idx), got_l._make_batch(idx)
        assert {"pboxes", "plogits", "pvalid"} <= set(want)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert want["pvalid"].any(1).all()
        for r, half in enumerate(halves):
            part = half._make_batch(idx)
            for k in ("image", "pboxes", "pvalid"):
                np.testing.assert_array_equal(part[k],
                                              want[k][2 * r:2 * r + 2])
    for pool in [want_l._pool, got_l._pool] + [h._pool for h in halves]:
        pool.shutdown()
    want_t = list(JaxTestLoader(names["val"], cfgs[0], (128, 128), 3))
    got_t = list(TestLoader(names["val"], cfgs[1], (128, 128), 3))
    assert len(want_t) == len(got_t) > 1
    for (gb, gm), (wb, wm) in zip(got_t, want_t):
        assert gm == wm and gb.keys() == wb.keys() == {
            "image", "sizes", "pboxes", "pvalid"}
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        assert wb["pboxes"].shape[1] == TOPK_TEST


# -------------------------------------------------------- the detector
@pytest.fixture(scope="module")
def dets():
    jcfg, tcfg = fast_rcnn_cfg(jax_get_cfg), fast_rcnn_cfg(port_get_cfg)
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed=3)
    tdet = build_detector(tcfg, device="cpu")
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    return jdet, variables, tdet


def test_forward_train_on_precomputed_proposals_matches_jax(dets):
    """Losses (no RPN loss) and every gradient; the RPN head takes no
    gradient (JAX's is zero)."""
    jdet, variables, tdet = dets
    batch = with_proposals(make_batch(seed=4))
    lab = batch["labeled"]
    rng = jax.random.PRNGKey(23)
    pre = {"boxes": lab["pboxes"], "valid": lab["pvalid"]}

    def loss_fn(params):
        v = {"params": params, "frozen": variables["frozen"]}
        losses, _ = jdet.forward_train(
            v, jnp.asarray(lab["image"]), jnp.asarray(lab["sizes"]),
            JaxInstances(boxes=jnp.asarray(lab["boxes"]),
                         classes=jnp.asarray(lab["classes"]),
                         valid=jnp.asarray(lab["valid"])), rng,
            precomputed={k: jnp.asarray(v) for k, v in pre.items()})
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    n_anchors = tdet.anchors_cat.shape[0]
    draws = draws_from.forward_train_draws(rng, tdet.cfg, 2, n_anchors)
    assert set(draws) == {"roi"}
    assert draws["roi"]["fill"].shape == (2, TOPK_TRAIN + 8)
    tb = torch_tree(batch)["labeled"]
    for k in (roi_align_fwd, roi_align_bwd):
        k.launches = 0
    losses, aux = tdet.forward_train(
        tdet.module, tb["image"], tb["sizes"],
        Instances(tb["boxes"], tb["classes"], tb["valid"]), draws,
        precomputed={"boxes": tb["pboxes"], "valid": tb["pvalid"]})
    assert set(losses) == set(want) == {"loss_cls", "loss_box_reg"}
    assert "rpn_logits" not in aux
    for k in want:
        close_rel(losses[k], want[k], what=k)
    sum(losses.values()).backward()
    assert (roi_align_fwd.launches, roi_align_bwd.launches) == (0, 0)
    want_g = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    params = dict(tdet.module.named_parameters())
    worst = 0.0
    for name, w in want_g.items():
        p = params[name]
        if p.grad is None:  # frozen stages and the idle RPN head
            assert not w.abs().max() > 0, name
            continue
        scale = max(float(w.abs().max()), 1e-6)
        worst = max(worst, max_err(p.grad.numpy(), w.numpy()) / scale)
    print(f"gradients: worst max abs err / tensor scale {worst:.3g}")
    assert worst <= 1e-4
    assert all(params[n].grad is None for n in params
               if n.startswith("proposal_generator."))
    assert aux["sampled"]["is_pos"].any()
    tdet.module.zero_grad(set_to_none=True)


def test_forward_inference_on_precomputed_proposals_matches_jax():
    jdet, variables, tdet = tiny_detectors(seed=1)
    images, sizes = tiny_images()
    rng = np.random.default_rng(5)
    pb = np.stack([proposal_arrays(np.zeros((0, 4)), TOPK_TEST, (128, 128),
                                   rng)[0] for _ in range(2)])
    pv = np.ones((2, TOPK_TEST), bool)
    pv[1, -5:] = False
    want = [np.asarray(a) for a in jdet.forward_inference(
        variables, jnp.asarray(images), jnp.asarray(sizes),
        precomputed={"boxes": jnp.asarray(pb), "valid": jnp.asarray(pv)})]
    got = [t.numpy() for t in tdet.forward_inference(
        torch.from_numpy(images), torch.from_numpy(sizes),
        precomputed={"boxes": torch.from_numpy(pb),
                     "valid": torch.from_numpy(pv)})]
    m = want[3]
    assert m.sum(1).min() > 0
    np.testing.assert_array_equal(got[3], m)
    box_err = max_err(got[0][m], want[0][m])
    score_err = max_err(got[1][m], want[1][m])
    print(f"Fast R-CNN inference: boxes max abs err {box_err:.3g}, scores "
          f"{score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-5
    np.testing.assert_array_equal(got[2][m], want[2][m])
    # the supplied proposals, not the RPN's: other proposals, other output
    other = tdet.forward_inference(torch.from_numpy(images),
                                   torch.from_numpy(sizes))
    assert not torch.equal(other[0], torch.from_numpy(got[0]))


def test_fast_rcnn_step_matches_jax():
    """One supervised Fast R-CNN step (EMA, strong views, SGD) of both
    packages on the same batch, proposals and draws: the losses, and every
    parameter after the step, the idle RPN head's too (its zero gradient
    still takes weight decay and momentum, as in the JAX package)."""
    jcfg = fast_rcnn_cfg(jax_get_cfg, saturated=True)
    tcfg = fast_rcnn_cfg(port_get_cfg, saturated=True)
    for cfg in (jcfg, tcfg):  # every candidate: 24 proposals + 8 gt
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = TOPK_TRAIN + 8
    variables = seeded_variables(jax_build_detector(jcfg), seed=5)
    batch = with_proposals(make_batch(seed=2), seed=2)
    rng = jax.random.PRNGKey(44)
    n_anchors = build_detector(tcfg, device="cpu").anchors_cat.shape[0]
    draws = draws_from.train_step_draws(rng, tcfg, 2, 2, n_anchors)
    (want_m, want_s, _) = _jax_steps(jcfg, variables, batch, [rng])
    got_m, state = _port_steps(tcfg, variables, batch, [draws])
    assert set(got_m[0]) == set(want_m[0]) == {
        "loss_cls_source_strong", "loss_box_reg_source_strong", "total_loss"}
    for k in want_m[0]:
        close_rel(got_m[0][k], want_m[0][k], what=k)
    start = jax_variables_to_state_dict(variables)
    got = dict(state.student.named_parameters())
    err = max(max_err(got[k].detach().numpy(), want_s[k].numpy())
              for k in want_s)
    rpn = [k for k in want_s if k.startswith("proposal_generator.")]
    rpn_moved = max(max_err(want_s[k].numpy(), start[k].numpy())
                    for k in rpn)
    # the RPN head's move, far below the parameters' tolerance, held alone
    rpn_err = max(max_err(got[k].detach().numpy() - start[k].numpy(),
                          want_s[k].numpy() - start[k].numpy()) for k in rpn)
    print(f"student after the step: max abs err {err:.3g}; the RPN head "
          f"moved by up to {rpn_moved:.3g} (weight decay), its move's max "
          f"abs err {rpn_err:.3g}")
    assert err <= 1e-5 and rpn_moved > 0 and rpn_err <= 1e-3 * rpn_moved


# -------------------------------------------------------- the trainer
@pytest.mark.parametrize("branch", DECODERS)
def test_fast_rcnn_trainer_trains_and_scores_as_jax(data, tmp_path,
                                                    monkeypatch, branch):
    """2 iterations and ``test()`` (``tests/test_proposals.py:164-189``):
    no RPN loss in ``metrics.json``; the AP of the trained weights on the
    test file's proposals equals the JAX evaluator's on the same weights
    and proposals."""
    decoder_branch(monkeypatch, branch)
    names, files = data
    cfg = data_cfg(port_get_cfg, names, files, tmp_path / "out")
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.freeze()
    with torch_threads(1):
        trainer = ALDITrainer(cfg)
        trainer.resume_or_load(resume=False)
        trainer.train()
        assert trainer.state.step == 2
        with open(os.path.join(cfg.OUTPUT_DIR, "metrics.json")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        loss_keys = [k for k in rows[-1] if k.startswith("loss")]
        print(f"metrics: {rows[-1]}")
        assert loss_keys and not any("rpn" in k for k in loss_keys)
        assert all(np.isfinite(rows[-1][k]) for k in loss_keys)
        got = trainer.test()[names["val"]]
    jcfg = data_cfg(jax_get_cfg, names, files, tmp_path / "jax")
    jcfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    jdet = jax_build_detector(jcfg)
    start = seeded_variables(jdet, seed=0)
    params, frozen = torch_state_dict_to_tree(
        port_state_as_reference(trainer.eval_module()),
        jax.tree_util.tree_map(np.asarray, dict(start["params"])),
        jax.tree_util.tree_map(np.asarray, dict(start["frozen"])))
    jdet._jit_infer = jdet.forward_inference  # un-jitted: no compile
    want = jax_evaluator.inference_on_dataset(
        jdet, {"params": params, "frozen": frozen}, names["val"], jcfg,
        distributed=False)
    print(f"AP: port {got}, JAX {want}")
    assert set(got) == set(want) and np.isfinite(got["bbox/AP50"])
    for k in want:
        if k == "images_per_sec":
            continue
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        if not np.isnan(want[k]):
            assert abs(got[k] - want[k]) <= 1e-6, k
    drop_weight_files(tmp_path)


# ---------------------------------------------------------- the rules
@pytest.mark.parametrize("rule", ["supervised-only", "GeneralizedRCNN"])
def test_load_proposals_rules_raise_as_jax(rule):
    """The JAX package's two rules, the only raises left: LOAD_PROPOSALS
    with a distill or align stream, and with another meta-architecture."""
    errors = []
    for get_cfg, build, make in (
            (jax_get_cfg, jax_build_detector,
             lambda c, d: jax_make_train_step(c, d, tx=None)),
            (port_get_cfg, lambda c: build_detector(c, device="cpu"),
             make_train_step)):
        if rule == "supervised-only":
            cfg = fast_rcnn_cfg(get_cfg)
            cfg.DATASETS.UNLABELED = ("synth_unlabeled",)
            cfg.DATASETS.BATCH_CONTENTS = ("labeled_strong",
                                           "unlabeled_strong")
            cfg.DATASETS.BATCH_RATIOS = (1, 1)
        else:
            cfg = fast_rcnn_cfg(get_cfg)
            cfg.MODEL.META_ARCHITECTURE = "DeformableDETR"
        with pytest.raises(NotImplementedError, match=rule) as e:
            make(cfg, build(cfg))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------ data parallel
def test_fast_rcnn_step_world2_equals_world1(tmp_path):
    """Two Fast R-CNN steps at world 2 (two gloo ranks, each on its share
    of a global batch of 4 images and of its proposals) against world 1."""
    cfg = fast_rcnn_cfg(port_get_cfg, saturated=True)
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    det = build_detector(cfg, device="cpu")
    weights = {k: v.clone() for k, v in det.module.state_dict().items()}
    batches, draws = [], []
    for i, seed in enumerate((2, 3)):
        b = with_proposals(make_batch(seed=seed, b=2), seed=seed)
        b2 = with_proposals(make_batch(seed=seed + 10, b=2), seed=seed + 10)
        lab = {k: np.concatenate([b["labeled"][k], b2["labeled"][k]])
               for k in b["labeled"]}
        batches.append(torch_tree({"labeled": lab, "unlabeled": {
            "image": np.zeros((0, 128, 128, 3), np.float32),
            "sizes": np.zeros((0, 2), np.int32)}}))
        draws.append(draw_step(torch.Generator().manual_seed(i), det, 4, 0))
    assert set(draws[0]) == {"strong", "aug_labeled"}
    assert set(draws[0]["strong"]) == {"roi"}
    cfg_dict = dist_run.portable(cfg)
    with torch_threads(1):
        w1_m, w1_s, w1_t = dist_run.daod_steps(0, 1, cfg_dict, weights,
                                               batches, draws)
    ranks = dist_run.run_ranks(dist_run.daod_steps, 2, tmp_path, cfg_dict,
                               weights, batches, draws)
    (m0, s0, t0), (m1, s1, _) = ranks
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert not any("rpn" in k for k in w1_m[0])
    check_metrics(rank_sums([m0, m1]), w1_m, 1e-4, "world 2 vs world 1")
    moved = max(max_err(w1_s[k].numpy(), weights[k].numpy()) for k in weights)
    print(f"the student's largest move: {moved:.3g}")
    assert moved >= 100 * 1e-4
    check_params(s0, w1_s, 1e-4, "world 2 vs world 1, student")
    check_params(t0, w1_t, 1e-4, "world 2 vs world 1, teacher")
