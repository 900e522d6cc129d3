"""The port's training CLI data parallel on the CPU:
``aldi_tpu_torch.tools.train_net`` ``main`` with ``--num-gpus 2`` and
``MODEL.DEVICE cpu`` spawns two gloo ranks (``tests/torch_port_dist.py``
``run_main`` runs the launcher in a process of its own, killed with its
ranks if it overruns). The tiny DAOD config of
``tests/test_torch_port_trainer.py`` (ResNet-26, canvas 128, 3 classes,
float32, 2 + 2 images per iteration) runs 4 iterations with a checkpoint
every 2 and an eval at 4 on ``tests/synthetic_data.py`` splits laid out
as Cityscapes under ``ALDI_DATASETS`` (the ranks register the datasets by
the names ``aldi_tpu_torch/data/datasets.py`` gives them), against the
same run at world 1 in this process.

Checks: one writer (rank 0: one ``metrics.json`` line per write point,
the checkpoints, ``trainer_state.json``, one log), the student and the
teacher within 1e-5 of world 1's after 2 iterations (as
``tests/test_torch_port_ddp.py`` holds two steps; 3e-8 measured) and
within 1e-4 after 4 (iterations 3 and 4 amplify the summation order's
rounding: world 1 alone differs by 2.3e-6 there between 1 and 3 threads,
world 2 from world 1 by 8.7e-6), the same AP (the test set scored in two
strided halves and gathered), and ``--resume`` at world 2 from the
iteration-2 checkpoint bitwise equal to the unbroken run. Then the
``pack_predictions`` rows against the JAX package's.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine.evaluator import pack_predictions as jax_pack
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.data import catalog
from aldi_tpu_torch.config import resolve_canvas
from aldi_tpu_torch.data.loader import TestLoader, WeakStrongLoader
from aldi_tpu_torch.engine.checkpoint import AUTHOR
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.evaluator import (pack_predictions,
                                             unpack_predictions)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.parallel.mesh import shard_positions
from aldi_tpu_torch.tools import train_net
from aldi_tpu_torch.utils import events
from tests import torch_port_dist as dist_run
from tests.synthetic_data import make_synthetic_coco
from tests.test_torch_port_train_step import daod_cfg
from tests.torch_port_common import (drop_weight_files, loader_cfg, max_err,
                                     seeded_variables)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

# split: (images, seed, fog, the Cityscapes layout's json and image dir)
SPLITS = {
    "train": (8, 0, False, "cityscapes_train_instances.json",
              "leftImg8bit/train", "cityscapes_train"),
    "unlabeled": (8, 2, True, "cityscapes_train_instances_foggyALL.json",
                  "leftImg8bit_foggy/train", "cityscapes_foggy_train"),
    "val": (4, 1, False, "cityscapes_val_instances_foggyALL.json",
            "leftImg8bit_foggy/val", "cityscapes_foggy_val"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 run on one thread, as each spawned rank."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """This process's writers without TensorBoard (where TensorFlow is
    installed, its first write imports it, about 20 s); the spawned ranks
    keep theirs."""
    def unavailable(*args):
        raise ImportError("TensorBoard left out of the tests")

    monkeypatch.setattr(events, "TensorBoardWriter", unavailable)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The splits under ``root/cityscapes``, the same files registered here
    under names of their own (this process's catalog may already hold the
    Cityscapes names at another root), and a weight file. The val split's
    boxes are those weights' own detections above 0.5, so that the eval
    (of the EMA teacher, which 4 iterations at EMA.ALPHA 0.9996 leave near
    them) scores a non-trivial AP that a lost or doubled image would
    change."""
    root = tmp_path_factory.mktemp("datasets")
    city = root / "cityscapes"
    (city / "annotations").mkdir(parents=True)
    here = {}
    for split, (n, seed, fog, js, images, _) in SPLITS.items():
        json_path, image_dir = make_synthetic_coco(
            str(root), f"raw_{split}", n, seed=seed, fog=fog)
        os.makedirs(os.path.dirname(city / images), exist_ok=True)
        shutil.move(image_dir, city / images)
        shutil.move(json_path, city / "annotations" / js)
        here[split] = f"ddp_trainer_{split}"
        if here[split] not in catalog.DatasetCatalog:
            catalog.register_coco_instances(
                here[split], {}, str(city / "annotations" / js),
                str(city / images))
    weights = jax_variables_to_state_dict(seeded_variables(
        jax_build_detector(daod_cfg(jax_get_cfg)), seed=6))
    torch.save({"model": weights, "__author__": AUTHOR}, root / "weights.pth")
    cfg = loader_cfg(daod_cfg(port_get_cfg), here)
    det = build_detector(cfg, device="cpu")
    det.module.load_state_dict(weights)
    val_json = city / "annotations" / SPLITS["val"][3]
    coco = json.loads(val_json.read_text())
    coco["annotations"] = []
    for batch, metas in TestLoader(here["val"], cfg, det.canvas):
        boxes, scores, classes, valid = det.forward_inference(
            torch.from_numpy(batch["image"]), torch.from_numpy(
                batch["sizes"]))
        for i, meta in enumerate(metas):
            for b, sc, cl in zip(boxes[i][valid[i]], scores[i][valid[i]],
                                 classes[i][valid[i]]):
                if sc > 0.5:
                    x0, y0, x1, y1 = (b / meta["scale"]).tolist()
                    coco["annotations"].append({
                        "id": len(coco["annotations"]) + 1,
                        "image_id": meta["image_id"],
                        "category_id": int(cl) + 1,
                        "bbox": [x0, y0, x1 - x0, y1 - y0],
                        "area": (x1 - x0) * (y1 - y0), "iscrowd": 0})
    assert len(coco["annotations"]) >= 4
    val_json.write_text(json.dumps(coco))
    return root, here


def write_cfg(path, names, out, weights, **overrides):
    cfg = loader_cfg(daod_cfg(port_get_cfg), names)
    cfg.MODEL.WEIGHTS = str(weights)
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = 4
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.TEST.EVAL_PERIOD = 4
    cfg.MODEL.DEVICE = "cpu"
    cfg.OUTPUT_DIR = str(out)
    cfg.SEED = 7
    cfg.VIS_PERIOD = 0
    for key, value in overrides.items():
        node, leaf = key.split(".")
        cfg[node][leaf] = value
    with open(path, "w") as f:
        f.write(cfg.dump())
    return str(path)


def ckpt(out, name="model_0000004"):
    return torch.load(os.path.join(out, f"{name}.pth"), weights_only=True)


def world2(root, cfg_path, *extra):
    return dist_run.run_main(
        ["--num-gpus", "2", "--config-file", cfg_path, *extra],
        {"ALDI_DATASETS": str(root), "OMP_NUM_THREADS": "1"})


def test_trainer_world2_writes_once_matches_world1_and_resumes(data,
                                                               tmp_path):
    root, here = data
    city = {s: v[5] for s, v in SPLITS.items()}
    # world 1, in this process
    out1 = tmp_path / "world1"
    args = train_net.default_argument_parser().parse_args(
        ["--config-file", write_cfg(tmp_path / "w1.yaml", here, out1,
                                    root / "weights.pth")])
    want = train_net.main(args)
    # world 2, unbroken
    out2 = tmp_path / "world2"
    cfg2 = write_cfg(tmp_path / "w2.yaml", city, out2, root / "weights.pth")
    got = world2(root, cfg2)
    try:
        ap1, ap2 = want[here["val"]], got[city["val"]]
        print(f"AP50 world 1 {ap1['bbox/AP50']}, world 2 {ap2['bbox/AP50']}")
        for k in ("bbox/AP", "bbox/AP50", "bbox/AP75"):
            assert ap2[k] == ap1[k], k
        assert ap1["bbox/AP50"] > 10
        # one writer: the same files, one metrics line per write point
        # (this process's logger may hold an earlier test's file, and its
        # writers leave TensorBoard out)
        files1 = sorted(set(os.listdir(out1)) - {"log.txt"})
        files2 = sorted(f.replace(city["val"], here["val"])
                        for f in os.listdir(out2))
        assert files2 == sorted(files1 + ["log.txt", "tensorboard"]), (
            files1, files2)
        assert {"model_0000002.pth", "model_0000004.pth", "metrics.json",
                "trainer_state.json", "last_checkpoint"} <= set(files1)
        lines = [open(os.path.join(o, "metrics.json")).read().splitlines()
                 for o in (out1, out2)]
        assert len(lines[1]) == len(lines[0]) == 1
        m1, m2 = (json.loads(line[0]) for line in lines)
        assert set(m1) == set(m2)
        for k in m1:
            if "loss" in k or k == "num_pseudo_labels":
                assert abs(m2[k] - m1[k]) <= 1e-4 * max(abs(m1[k]), 1e-3), k
        for it, tol in (("model_0000002", 1e-5), ("model_0000004", 1e-4)):
            c1, c2 = ckpt(out1, it), ckpt(out2, it)
            for part in ("model", "ema"):
                err = max(max_err(c2[part][k].numpy(), v.numpy())
                          for k, v in c1[part].items())
                print(f"{it}, {part}: world 2 vs world 1 max abs err "
                      f"{err:.3g} (tol {tol})")
                assert err <= tol, (it, part)
        # --resume at world 2 from the iteration-2 checkpoint
        out3 = tmp_path / "resumed"
        out3.mkdir()
        shutil.copy(out2 / "model_0000002.pth", out3)
        (out3 / "last_checkpoint").write_text("model_0000002")
        world2(root, write_cfg(tmp_path / "w3.yaml", city, out3,
                               root / "weights.pth"), "--resume")
        c3 = ckpt(out3)
        assert c3["iteration"] == 4
        for part in ("model", "ema", "optimizer"):
            assert _equal(c3[part], c2[part]), part
    finally:
        for out in (out1, out2, tmp_path / "resumed"):
            drop_weight_files(out)


@pytest.mark.parametrize("accum", [1, 2])
def test_loader_shards_are_the_world1_batch(data, accum):
    """A rank's loader delivers its ``shard_positions`` of the world-1
    batch, bit for bit, with the random crop on (its draws read the
    image's size from the file's header, for the records the rank does not
    decode too)."""
    _, here = data
    cfg = loader_cfg(daod_cfg(port_get_cfg), here)
    cfg.SOLVER.IMS_PER_BATCH = 8
    cfg.TPU.GRAD_ACCUM = accum
    cfg.INPUT.CROP.ENABLED = True
    canvas = resolve_canvas(cfg)
    full = WeakStrongLoader(cfg, canvas, seed=3, num_threads=1)
    ranks = [WeakStrongLoader(cfg, canvas, seed=3, num_threads=1,
                              shard=(r, 2)) for r in (0, 1)]
    for it in range(2):
        want = next(full)
        for r, loader in enumerate(ranks):
            got = next(loader)
            pos = shard_positions(4, accum, r, 2)
            for stream, arrays in want.items():
                assert set(got[stream]) == set(arrays)
                for k, v in arrays.items():
                    np.testing.assert_array_equal(got[stream][k], v[pos],
                                                  err_msg=f"{it} {k}")


def test_launcher_without_cards_raises(data, tmp_path):
    """``--num-gpus 2`` on the cards (the YAMLs' MODEL.DEVICE) raises here,
    before any process starts: this machine has no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _, here = data
    cfg = write_cfg(tmp_path / "c.yaml", here, tmp_path / "out", "")
    args = train_net.default_argument_parser().parse_args(
        ["--num-gpus", "2", "--config-file", cfg, "MODEL.DEVICE", "cuda"])
    with pytest.raises(RuntimeError, match="--num-gpus 2 but 0 CUDA"):
        train_net.main(args)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_pack_round_trip_matches_jax_rows():
    """``pack_predictions`` gives the JAX package's rows (the image id in
    two float32 columns, exact past 2^24), and ``unpack_predictions``
    inverts it over ragged per-rank counts with padding."""
    preds = {7: [{"bbox": [1.5, 2.0, 3.0, 4.0], "score": 0.75,
                  "category_id": 2}],
             (1 << 24) + 3: [{"bbox": [0.0, 1.0, 2.0, 3.0], "score": 0.5,
                              "category_id": 0},
                             {"bbox": [5.0, 6.0, 7.0, 8.0], "score": 0.25,
                              "category_id": 1}]}
    rows = pack_predictions(preds)
    np.testing.assert_array_equal(rows, jax_pack(preds))
    assert rows.shape == (3, 8) and rows.dtype == np.float32
    gathered = np.zeros((2, 3, 8), np.float32)
    gathered[0, :1], gathered[1, :2] = rows[:1], rows[1:]
    gathered[0, 1:] = 99.0  # padding beyond rank 0's count
    assert unpack_predictions(gathered, np.array([1, 2])) == preds
    assert unpack_predictions(pack_predictions({})[None], np.array([0])) \
        == {}
