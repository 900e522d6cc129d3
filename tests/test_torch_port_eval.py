"""The port's evaluation against the JAX package's, on the CPU.

``evaluate_detections`` (plain numpy in both) on seeded random detections
with crowd and ignore-flagged gt, held to 1e-12. ``inference_on_dataset``
of the tiny R-CNN (``tests/torch_port_common.py``, weights carried across
by ``jax_variables_to_state_dict``) on a synthetic split: the predictions
it scores (boxes to 1e-3 px of up to 128, scores to 1e-5) and its AP dict
(all keys but ``images_per_sec``) to 1e-6. The JAX detector runs its
un-jitted ``forward_inference``, so no JAX graph is compiled.
"""

import json
import os

import numpy as np
import pytest

import aldi_tpu.engine.evaluator as jax_evaluator
import aldi_tpu_torch.engine.evaluator as port_evaluator
from aldi_tpu.data import catalog as jax_catalog
from aldi_tpu.engine.coco_eval import \
    evaluate_detections as jax_evaluate_detections
from aldi_tpu_torch.data import catalog as port_catalog
from aldi_tpu_torch.engine.coco_eval import evaluate_detections
from tests.torch_port_common import (DECODERS, decoder_branch,
                                     loader_cfg, register_synthetic_both,
                                     tiny_detectors)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def random_case(seed, n_images=12, n_cats=3):
    """Gt (some crowd, some ignore-flagged, some with an area outside its
    box's) and detections around and away from it."""
    rng = np.random.default_rng(seed)
    annotations, predictions = {}, {}
    for img in range(1, n_images + 1):
        gts = []
        for _ in range(int(rng.integers(0, 6))):
            x, y = rng.uniform(0, 400, 2)
            w, h = np.exp(rng.uniform(np.log(8), np.log(200), 2))
            g = {"bbox": [float(x), float(y), float(w), float(h)],
                 "category_id": int(rng.integers(0, n_cats)),
                 "iscrowd": int(rng.uniform() < 0.1),
                 "ignore": int(rng.uniform() < 0.1)}
            if rng.uniform() < 0.3:
                g["area"] = float(w * h * rng.uniform(0.3, 1.0))
            gts.append(g)
        annotations[img] = gts
        dets = []
        for g in gts:
            for _ in range(int(rng.integers(0, 3))):
                jit = rng.normal(0, 0.15, 4) * np.array(g["bbox"][2:] * 2)
                dets.append({"bbox": [float(v) for v in
                                      np.array(g["bbox"]) + jit],
                             "score": float(rng.uniform()),
                             "category_id": g["category_id"]
                             if rng.uniform() < 0.85
                             else int(rng.integers(0, n_cats))})
        for _ in range(int(rng.integers(0, 4))):
            x, y = rng.uniform(0, 400, 2)
            w, h = np.exp(rng.uniform(np.log(8), np.log(200), 2))
            dets.append({"bbox": [float(x), float(y), float(w), float(h)],
                         "score": float(rng.uniform()),
                         "category_id": int(rng.integers(0, n_cats))})
        if dets:
            predictions[img] = dets
    return predictions, annotations


def gt_from_detections(root, name, predictions):
    """A split ``{name}_found`` on ``name``'s images whose gt are every
    third detection of each image, shifted by up to 3 px, plus a crowd
    box, registered in both catalogs."""
    md = port_catalog.MetadataCatalog.get(name)
    with open(md["json_file"]) as f:
        coco = json.load(f)
    rng = np.random.default_rng(0)
    anns = []
    for img, dets in sorted(predictions.items()):
        for d in dets[::3]:
            x, y, w, h = (np.asarray(d["bbox"]) + rng.uniform(-3, 3, 4))
            anns.append({"id": len(anns) + 1, "image_id": img,
                         "category_id": d["category_id"] + 1,
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "iscrowd": 0})
        anns.append({"id": len(anns) + 1, "image_id": img, "category_id": 1,
                     "bbox": [0.0, 0.0, 40.0, 30.0], "iscrowd": 1})
    coco["annotations"] = anns
    found = f"{name}_found"
    path = os.path.join(str(root), f"{found}.json")
    with open(path, "w") as f:
        json.dump(coco, f)
    for cat in (jax_catalog, port_catalog):
        cat.register_coco_instances(found, {}, path, md["image_root"])
    return found


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluate_detections_matches_jax(seed):
    predictions, annotations = random_case(seed)
    got = evaluate_detections(predictions, annotations, [0, 1, 2])
    want = jax_evaluate_detections(predictions, annotations, [0, 1, 2])
    assert set(got) == set(want)
    err = max(abs(got[k] - want[k]) for k in want
              if not np.isnan(want[k]))
    print(f"seed {seed}: {got}; max abs err {err:.3g}")
    for k in want:
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        if not np.isnan(want[k]):
            assert abs(got[k] - want[k]) <= 1e-12, k
    assert 0 < want["bbox/AP50"] < 100


@pytest.mark.parametrize("branch", DECODERS)
def test_inference_on_dataset_matches_jax(tmp_path, monkeypatch, branch):
    decoder_branch(monkeypatch, branch)
    names = register_synthetic_both(tmp_path, f"port_eval_{branch}",
                                    {"val": (4, 4, False)})
    jdet, variables, tdet = tiny_detectors(seed=0)
    jdet._jit_infer = jdet.forward_inference  # un-jitted: no compile
    for det in (jdet, tdet):
        loader_cfg(det.cfg, dict(names, train="", unlabeled=""))
        det.cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    scored = {}

    def capture(module, key):
        real = module.evaluate_detections

        def spy(predictions, annotations, category_ids):
            scored[key] = predictions
            return real(predictions, annotations, category_ids)
        monkeypatch.setattr(module, "evaluate_detections", spy)

    capture(jax_evaluator, "jax")
    capture(port_evaluator, "port")
    # gt that the random-weight detector partly finds: a split on the same
    # images whose annotations are some of its detections, moved a little
    port_evaluator.inference_on_dataset(tdet, names["val"], tdet.cfg,
                                        batch_size=4)
    name = gt_from_detections(tmp_path, names["val"], scored.pop("port"))
    want = jax_evaluator.inference_on_dataset(
        jdet, variables, name, jdet.cfg, batch_size=4)
    got = port_evaluator.inference_on_dataset(
        tdet, name, tdet.cfg, batch_size=4)
    # the detections scored: the same per image, in the same order
    assert scored["port"].keys() == scored["jax"].keys()
    n, box_err, score_err = 0, 0.0, 0.0
    for img, dets in scored["jax"].items():
        assert len(scored["port"][img]) == len(dets)
        for g, w in zip(scored["port"][img], dets):
            assert g["category_id"] == w["category_id"]
            box_err = max(box_err, np.abs(np.subtract(g["bbox"],
                                                      w["bbox"])).max())
            score_err = max(score_err, abs(g["score"] - w["score"]))
            n += 1
    print(f"{n} detections: boxes max abs err {box_err:.3g}, scores "
          f"{score_err:.3g}; AP {got} vs {want}")
    assert n > 0 and box_err <= 1e-3 and score_err <= 1e-5
    assert set(got) == set(want) and want["bbox/AP50"] > 10
    for k in want:
        if k == "images_per_sec":
            continue
        assert np.isnan(got[k]) == np.isnan(want[k]), k
        if not np.isnan(want[k]):
            assert abs(got[k] - want[k]) <= 1e-6, k
