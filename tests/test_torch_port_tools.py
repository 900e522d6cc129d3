"""The port's user tools (``aldi_tpu_torch/tools/{calibrate_threshold,
debug_pipeline,visualize_featurespace}.py``) against the JAX repository's
(``tools/``), on the CPU.

- ``recommend_threshold`` equals the JAX tool's on the rows of
  ``tests/test_calibrate_threshold.py``; ``pca_2d`` equals it up to each
  axis's sign (an SVD's singular vectors are signed freely).
- Each tool's ``main --device cpu`` runs on the tiny flagship config of
  ``tests/test_torch_port_train_step.py`` (ResNet-26, canvas 128, float32)
  over ``tests/synthetic_data.py`` splits registered in both catalogs, from
  one reference ``.pth`` (seeded weights in detectron2's layout) that both
  packages load.
- ``debug_pipeline``: the weak images and their gt boxes exactly equal to
  the JAX tool's, and the teacher's pseudo-labels on the same weights:
  validity exactly, boxes within 1e-3 px. (The strong views
  come from each package's own random draws.)
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import tools.calibrate_threshold as jax_calibrate
import tools.debug_pipeline as jax_debug
import tools.visualize_featurespace as jax_featurespace
from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.tools import calibrate_threshold, debug_pipeline
from aldi_tpu_torch.tools import visualize_featurespace
from aldi_tpu_torch.utils import events
from tests.test_torch_port_train_step import daod_cfg
from tests.torch_port_common import (DECODERS, decoder_branch,
                                     loader_cfg, max_err,
                                     port_state_as_reference,
                                     register_synthetic_both,
                                     seeded_variables)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


def _rows(mean, std, n_images=256, dets=20, seed=0):
    rng = np.random.default_rng(seed)
    return [np.clip(rng.normal(mean, std, dets), 0, 1)
            for _ in range(n_images)]


def _floor_rows():
    rng = np.random.default_rng(1)
    return [np.concatenate([rng.uniform(0.0, 0.04, 50),
                            rng.uniform(0.5, 0.9, 3)]) for _ in range(64)]


@pytest.mark.parametrize("rows,gt", [
    (_rows(0.26, 0.05), 2.04), (_rows(0.3, 0.08), 1.0),
    (_rows(0.3, 0.08), 4.0), ([np.array([0.2, 0.03])] * 4, 2.0),
    ([], 2.0), (_floor_rows(), 2.0), ([np.zeros(0)] * 3, 1.0),
], ids=["density", "sparse", "dense", "starved", "empty", "floor",
        "no-detections"])
def test_recommend_threshold_equals_jax(rows, gt):
    got = calibrate_threshold.recommend_threshold(rows, gt)
    want = jax_calibrate.recommend_threshold(rows, gt)
    print(f"recommended threshold {got} (JAX {want})")
    assert got == want


def test_pca_2d_equals_jax_up_to_sign():
    x = np.random.default_rng(2).standard_normal((40, 16)).astype(
        np.float32) * np.linspace(3, 0.1, 16, dtype=np.float32)
    got = visualize_featurespace.pca_2d(x)
    want = jax_featurespace.pca_2d(x)
    signs = np.sign((got * want).sum(0))
    assert got.shape == (40, 2) and np.all(np.abs(signs) == 1)
    np.testing.assert_allclose(got * signs, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The writers without TensorBoard (its first write imports TensorFlow
    here)."""
    def unavailable(*args):
        raise ImportError("TensorBoard left out of the tests")

    monkeypatch.setattr(events, "TensorBoardWriter", unavailable)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic splits, the tiny config as a YAML both packages read,
    and a reference ``.pth`` of seeded weights."""
    root = tmp_path_factory.mktemp("tools")
    names = register_synthetic_both(root, "port_tools")
    cfg = loader_cfg(daod_cfg(jax_get_cfg), names)
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.MODEL.DEVICE = "cpu"
    cfg.OUTPUT_DIR = str(root / "out")
    cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD = 0.3
    yaml = str(root / "tiny.yaml")
    with open(yaml, "w") as f:
        f.write(cfg.dump())
    variables = seeded_variables(jax_build_detector(cfg), seed=4)
    from aldi_tpu_torch.config import get_cfg as port_get_cfg
    from aldi_tpu_torch.models import build_detector

    pcfg = port_get_cfg()
    pcfg.merge_from_file(yaml)
    det = build_detector(pcfg, device="cpu")
    det.module.load_state_dict(jax_variables_to_state_dict(variables))
    weights = str(root / "weights.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in
                          port_state_as_reference(det.module).items()}},
               weights)
    return names, yaml, weights, root


def test_calibrate_threshold_main_runs_on_cpu(setup):
    names, yaml, weights, root = setup
    out = str(root / "calibration.json")
    report = calibrate_threshold.main(
        ["--config-file", yaml, "--device", "cpu", "--out", out,
         "--dataset", names["val"], "MODEL.WEIGHTS", weights])
    with open(out) as f:
        assert json.load(f) == report
    print(report)
    assert report["images"] == 4 and report["detections"] > 0
    assert report["gt_per_image"] > 0
    thr = report["recommended_threshold"]
    assert thr is None or 0.05 < thr <= 1.0


def test_tools_default_to_cuda(setup, monkeypatch):
    """Without a card each tool's default device raises; none falls back
    to the CPU."""
    names, yaml, weights, root = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in (
            (calibrate_threshold.main, ["--dataset", names["val"]]),
            (debug_pipeline.main, ["--out", str(root / "no_card")]),
            (visualize_featurespace.main,
             ["--datasets", names["train"], names["val"]])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config-file", yaml, *args])


@pytest.mark.parametrize("branch", DECODERS)
def test_debug_pipeline_matches_jax(setup, monkeypatch, branch):
    names, yaml, weights, root = setup
    decoder_branch(monkeypatch, branch)
    drawn = {}

    def capture(img, boxes, valid, path, **kw):
        drawn[os.path.basename(path)] = (np.asarray(img), np.asarray(boxes),
                                         np.asarray(valid))

    monkeypatch.setattr(jax_debug, "draw", capture)
    monkeypatch.setattr(sys, "argv", [
        "debug_pipeline.py", "--config-file", yaml, "--out",
        str(root / "jax_debug"), "MODEL.WEIGHTS", weights])
    jax_debug.main()
    out = str(root / "port_debug")
    got = debug_pipeline.main(["--config-file", yaml, "--device", "cpu",
                               "--out", out, "MODEL.WEIGHTS", weights])
    files = sorted(os.listdir(out))
    print(f"wrote {files}")
    assert files == sorted(drawn) == sorted(
        f"{k}_{i}.png" for k in ("weak", "strong", "pseudo")
        for i in range(2))
    lab = got["batch"]["labeled"]
    for i in range(2):
        img, boxes, valid = drawn[f"weak_{i}.png"]
        np.testing.assert_array_equal(lab["image"][i], img)
        np.testing.assert_array_equal(lab["boxes"][i], boxes)
        np.testing.assert_array_equal(lab["valid"][i], valid)
    pseudo = got["pseudo"]
    n = 0
    for i in range(2):
        _, boxes, valid = drawn[f"pseudo_{i}.png"]
        np.testing.assert_array_equal(pseudo.valid[i].numpy(), valid)
        n += int(valid.sum())
        err = max_err(pseudo.boxes[i].numpy()[valid], boxes[valid])
        print(f"image {i}: {int(valid.sum())} pseudo-labels, boxes max abs "
              f"err {err:.3g}")
        assert err <= 1e-3
    assert n > 0


@pytest.mark.parametrize("matplotlib", [True, False],
                         ids=["png", "npy-without-matplotlib"])
def test_visualize_featurespace_main_runs_on_cpu(setup, monkeypatch,
                                                 matplotlib):
    names, yaml, weights, root = setup
    if not matplotlib:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(root / f"featurespace_{matplotlib}.png")
    xy = visualize_featurespace.main(
        ["--config-file", yaml, "--device", "cpu", "--weights", weights,
         "--datasets", names["train"], names["unlabeled"], "--num-images",
         "4", "--level", "1", "--out", out])
    assert xy.shape == (8, 2) and np.isfinite(xy).all()
    if matplotlib:
        assert os.path.getsize(out) > 0
    else:
        np.testing.assert_array_equal(np.load(out + ".npy"), xy)
