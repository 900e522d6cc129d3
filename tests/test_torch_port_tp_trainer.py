"""The port's trainer on the data x model grid, on the CPU: the
counterpart of ``tests/test_trainer_mesh.py``. ``aldi_tpu_torch.tools.
train_net`` ``main`` with ``--num-gpus 4 TPU.MESH_MODEL 2 TPU.FSDP True``
(``MODEL.DEVICE cpu``) spawns four gloo ranks laid out as D = 2 data x
M = 2 model ranks, on the tiny DAOD config and the Cityscapes-named
splits of ``tests/test_torch_port_ddp_trainer.py`` (2 + 2 images per
iteration): 3 iterations, checkpoints at 2 and 3, an eval at 3.

Checks: the run logs JAX's mesh line and evaluates (bbox/AP50 present,
the test set scored by the two data ranks); its checkpoints hold world 1's
full tensors, which load into a world-1 trainer here and equal the
checkpoint's, and are within 1e-4 of a world-1 run's after 3 iterations
(as ``tests/test_torch_port_ddp_trainer.py`` holds its later iterations;
measured 4.5e-8 for the student, 7.5e-9 for the teacher); ``--resume`` on
the grid from the iteration-2 checkpoint writes an iteration-3 checkpoint
(student, teacher, optimizer) bitwise equal to the unbroken run's.
"""

import os
import shutil

import pytest
import torch

from aldi_tpu_torch.engine.checkpoint import Checkpointer
from aldi_tpu_torch.engine.trainer import ALDITrainer
from aldi_tpu_torch.tools import train_net
from tests import torch_port_dist as dist_run
from tests.test_torch_port_ddp_trainer import (SPLITS, _equal, ckpt,  # noqa
                                               data, no_tensorboard,
                                               write_cfg)
from tests.torch_port_common import drop_weight_files, max_err
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

GRID = ("TPU.MESH_MODEL", "2", "TPU.FSDP", "True")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 run on one thread, as each spawned rank."""
    with torch_threads(1):
        yield


def grid_run(root, cfg_path, *extra):
    return dist_run.run_main(
        ["--num-gpus", "4", "--config-file", cfg_path, *extra, *GRID],
        {"ALDI_DATASETS": str(root), "OMP_NUM_THREADS": "1"},
        timeout=400)


def test_trainer_on_2x2_checkpoints_evaluates_and_resumes(data, tmp_path):
    root, here = data
    city = {s: v[5] for s, v in SPLITS.items()}
    over = {"SOLVER.MAX_ITER": 3, "TEST.EVAL_PERIOD": 3}
    weights = root / "weights.pth"
    out = tmp_path / "grid"
    got = grid_run(root, write_cfg(tmp_path / "g.yaml", city, out, weights,
                                   **over))
    out1 = tmp_path / "world1"
    cfg1 = write_cfg(tmp_path / "w1.yaml", here, out1, weights, **over)
    try:
        log = (out / "log.txt").read_text()
        assert ("Mesh over 4 devices: data=2 x model=2 (Megatron MLP "
                "sharding) + FSDP weight/optimizer sharding") in log
        ap = got[city["val"]]
        print(f"AP50 on the 2 x 2 grid: {ap['bbox/AP50']}")
        assert "bbox/AP50" in ap and ap["bbox/AP50"] > 0
        assert {"model_0000002.pth", "model_0000003.pth",
                "last_checkpoint"} <= set(os.listdir(out))
        # world 1 loads the grid's checkpoint: world 1's full tensors
        c3 = ckpt(out, "model_0000003")
        args = train_net.default_argument_parser().parse_args(
            ["--config-file", cfg1])
        trainer = ALDITrainer(train_net.setup(args))
        Checkpointer(str(out)).load(str(out / "model_0000003.pth"),
                                    trainer.state)
        assert trainer.state.step == 3
        sd = trainer.state.student.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in c3["model"].items())
        # a world-1 run of the same iterations
        train_net.main(args)
        w1 = ckpt(out1, "model_0000003")
        for part in ("model", "ema"):
            err = max(max_err(c3[part][k].numpy(), v.numpy())
                      for k, v in w1[part].items())
            print(f"iteration 3, {part}: the 2 x 2 grid vs world 1 max abs "
                  f"err {err:.3g} (tol 1e-4)")
            assert err <= 1e-4, part
        # --resume on the grid from iteration 2
        out3 = tmp_path / "resumed"
        out3.mkdir()
        shutil.copy(out / "model_0000002.pth", out3)
        (out3 / "last_checkpoint").write_text("model_0000002")
        grid_run(root, write_cfg(tmp_path / "r.yaml", city, out3, weights,
                                 **over), "--resume")
        r3 = ckpt(out3, "model_0000003")
        assert r3["iteration"] == 3
        for part in ("model", "ema", "optimizer"):
            assert _equal(r3[part], c3[part]), part
    finally:
        for o in (out, out1, tmp_path / "resumed"):
            drop_weight_files(o)
