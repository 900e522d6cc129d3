"""The port's host data path against the JAX package's, on the CPU:
``load_coco_json``/``filter_empty`` records, ``transform_record`` and the
``StreamLoader``/``WeakStrongLoader``/``TestLoader`` batches on each
decoder branch (both packages' native cores, or both on PIL:
``tests/torch_port_common.py`` ``decoder_branch``), and the shift
benchmark's generator. Everything is held exactly equal:
images, sizes, boxes, classes, valid masks and scales, for the same numpy
seeds. ``DevicePrefetcher`` on the CPU hands over the host batches as
tensors and raises the loader's exceptions in the consumer.
"""

import json

import numpy as np
import pytest
import torch

import aldi_tpu.data.transforms as jax_transforms
from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.data.coco import filter_empty as jax_filter_empty
from aldi_tpu.data.coco import load_coco_json as jax_load_coco_json
from aldi_tpu.data.loader import TestLoader as JaxTestLoader
from aldi_tpu.data.loader import WeakStrongLoader as JaxWeakStrongLoader
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.data.coco import filter_empty, load_coco_json
from aldi_tpu_torch.data.loader import (DevicePrefetcher, TestLoader,
                                        WeakStrongLoader)
from aldi_tpu_torch.data.transforms import transform_record
from aldi_tpu_torch.tools.efficacy import make_shift_split
from tests.shift_benchmark import make_shift_split as jax_make_shift_split
from tests.synthetic_data import make_synthetic_coco
from tests.torch_port_common import (DECODERS, decoder_branch, loader_cfg,
                                     register_synthetic_both, tiny_cfg)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


@pytest.fixture(params=DECODERS)
def branch(request, monkeypatch):
    """Both packages on one decoder branch."""
    decoder_branch(monkeypatch, request.param)
    return request.param


def assert_equal_trees(got, want, what=""):
    assert type(got) is type(want) or not isinstance(want, dict), what
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_equal_trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


@pytest.fixture(scope="module")
def coco_json(tmp_path_factory):
    """A synthetic split with a crowd, an ignore-flagged annotation and an
    image without annotations added."""
    root = tmp_path_factory.mktemp("coco")
    jp, ir = make_synthetic_coco(str(root), "recs", 5, seed=3)
    with open(jp) as f:
        coco = json.load(f)
    coco["annotations"] += [
        {"id": 100, "image_id": 1, "category_id": 2, "bbox": [5, 6, 30, 20],
         "area": 600, "iscrowd": 1},
        {"id": 101, "image_id": 2, "category_id": 3, "bbox": [1, 2, 12, 14],
         "iscrowd": 0, "ignore": 1},
        {"id": 102, "image_id": 6, "category_id": 1, "bbox": [0, 0, 9, 9],
         "iscrowd": 1},
    ]
    coco["images"].append({"id": 6, "file_name": "img_0000.png",
                           "height": 96, "width": 128})
    coco["images"].append({"id": 7, "file_name": "img_0001.png",
                           "height": 96, "width": 128})
    with open(jp, "w") as f:
        json.dump(coco, f)
    return jp, ir


def test_coco_records_match_jax(coco_json):
    jp, ir = coco_json
    got, want = load_coco_json(jp, ir), jax_load_coco_json(jp, ir)
    assert got == want and len(want) == 7
    assert any(a["iscrowd"] for r in want for a in r["annotations"])
    assert any(a["ignore"] for r in want for a in r["annotations"])
    kept = filter_empty(got)
    assert kept == jax_filter_empty(want) and len(kept) == 5


TRANSFORMS = {
    "choice": dict(min_sizes=[96, 112, 128], max_size=160),
    "range": dict(min_sizes=[90, 130], max_size=170, sampling="range"),
    "crop relative_range": dict(
        min_sizes=[96, 128], max_size=160,
        crop={"enabled": True, "type": "relative_range", "size": [0.6, 0.7]}),
    "crop absolute_range": dict(
        min_sizes=[112], max_size=160,
        crop={"enabled": True, "type": "absolute_range", "size": [40, 90]}),
    "rgb, no flip": dict(min_sizes=[100], max_size=150, bgr=False,
                         flip=False),
    "test": dict(min_sizes=[96], max_size=128, is_train=False),
    "canvas smaller than the resize": dict(min_sizes=[128], max_size=200),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transform_record_matches_jax(coco_json, case, branch):
    jp, ir = coco_json
    records = [r for r in load_coco_json(jp, ir) if r["annotations"]]
    kw = dict(canvas=(160, 224), max_gt=4, **TRANSFORMS[case])
    if case == "canvas smaller than the resize":
        kw["canvas"] = (96, 128)
    flips = set()
    for seed in range(6):
        rec = records[seed % len(records)]
        got = transform_record(rec, np.random.default_rng(seed), **kw)
        want = jax_transforms.transform_record(
            rec, np.random.default_rng(seed), **kw)
        assert_equal_trees(got, want, f"{case} seed {seed}")
        # the flip shows in the boxes of a record that has a box
        flips.add(bool(want["valid"].any() and not np.array_equal(
            want["boxes"][0], transform_record(
                rec, np.random.default_rng(seed),
                **dict(kw, flip=False))["boxes"][0])))
    if case in ("choice", "range"):
        assert flips == {True, False}


@pytest.fixture(scope="module")
def names(tmp_path_factory):
    return register_synthetic_both(tmp_path_factory.mktemp("data"),
                                   "port_data")


def _cfgs(names):
    cfgs = []
    for get_cfg in (port_get_cfg, jax_get_cfg):
        cfg = loader_cfg(tiny_cfg(get_cfg), names)
        cfg.DATASETS.BATCH_CONTENTS = ("labeled_strong", "unlabeled_strong")
        cfg.DATASETS.BATCH_RATIOS = (1, 1)
        cfg.SOLVER.IMS_PER_BATCH = 6  # 3 + 3 images: an epoch is 8
        cfg.INPUT.CROP.ENABLED = True
        cfg.INPUT.CROP.TYPE = "relative_range"
        cfg.INPUT.CROP.SIZE = [0.8, 0.8]
        cfg.TPU.PREFETCH = 1
        cfgs.append(cfg)
    return cfgs


def test_weak_strong_loader_matches_jax(names, branch):
    """Batches 0-3 (across the epoch boundary of both streams), then
    batches 7 and 8 after seek(7)."""
    cfg, jcfg = _cfgs(names)
    got = WeakStrongLoader(cfg, (128, 128), seed=5)
    want = JaxWeakStrongLoader(jcfg, (128, 128), seed=5)
    for i in range(4):
        assert_equal_trees(next(got), next(want), f"batch {i}")
    got.seek(7)
    want.seek(7)
    for i in (7, 8):
        assert_equal_trees(next(got), next(want), f"batch {i}")
    b = next(got)
    assert b["labeled"]["image"].shape == (3, 128, 128, 3)
    assert b["unlabeled"].keys() == {"image", "sizes"}


def test_test_loader_matches_jax(names, branch):
    cfg, jcfg = _cfgs(names)
    got = list(TestLoader(names["val"], cfg, (128, 128), batch_size=3))
    want = list(JaxTestLoader(names["val"], jcfg, (128, 128), batch_size=3))
    assert len(got) == len(want) == 2  # 4 images: the second batch padded
    for (gb, gm), (wb, wm) in zip(got, want):
        assert_equal_trees(gb, wb)
        assert gm == wm


def test_device_prefetcher_on_the_cpu(names):
    cfg, _ = _cfgs(names)
    host = WeakStrongLoader(cfg, (128, 128), seed=5)
    want = [next(host) for _ in range(3)]
    host.seek(0)
    pre = DevicePrefetcher(host, "cpu", depth=2)
    for i in range(3):
        got = next(pre)
        for s in ("labeled", "unlabeled"):
            for k, v in want[i][s].items():
                assert isinstance(got[s][k], torch.Tensor)
                np.testing.assert_array_equal(got[s][k].numpy(), v)
    pre.close()  # with a full queue: the copy thread waits to put
    assert not pre._thread.is_alive()

    def broken():
        yield want[0]
        raise FileNotFoundError("img_0042.png")

    pre = DevicePrefetcher(broken(), "cpu", depth=2)
    next(pre)
    with pytest.raises(FileNotFoundError, match="img_0042"):
        next(pre)
    pre.close()
    assert not pre._thread.is_alive()


def test_device_prefetcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetcher(iter([]))


@pytest.mark.parametrize("shifted", [False, True])
def test_make_shift_split_matches_jax(tmp_path, shifted):
    """The port's copy of the shift benchmark's generator: the same JSON
    and the same pixels on a 4-image split."""
    got_json, got_dir = make_shift_split(str(tmp_path / "port"), "s", 4, 13,
                                         shifted)
    want_json, want_dir = jax_make_shift_split(str(tmp_path / "jax"), "s", 4,
                                               13, shifted)
    with open(got_json) as g, open(want_json) as w:
        assert json.load(g) == json.load(w)
    from PIL import Image

    for i in range(4):
        name = f"img_{i:04d}.png"
        np.testing.assert_array_equal(
            np.asarray(Image.open(f"{got_dir}/{name}")),
            np.asarray(Image.open(f"{want_dir}/{name}")))
