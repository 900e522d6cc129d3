"""Reference-weight loading and the port's own checkpoints, on the CPU.

Reference files are built from the torch oracles with detectron2's names
(``tests/torch_rcnn_oracle.py``, ``tests/torch_vit_oracle.py``) and random
weights: an ALDI ``.pth`` ``{model, ema}`` (different seeds), a plain
``.pth`` state dict and a detectron2 zoo ``.pkl`` (numpy arrays). The
port's ``load_reference_weights`` must give exactly what the JAX package's
``load_reference_weights`` gives, carried across by
``jax_variables_to_state_dict``, from the same starting weights: the box
head's ``fc1`` permuted from channel-major to (h, w, c), a ViT
``pos_embed`` of tokens (with a class token) reshaped to its grid, the EMA
entry first when asked, and every other key as stored. The teacher gets
the student's weights. The port's checkpoints round-trip bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine.checkpoint import \
    load_reference_weights as jax_load_reference_weights
from aldi_tpu.engine.train_step import TrainState as JaxTrainState
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint import (Checkpointer,
                                              load_reference_weights)
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.train_step import create_train_state
from aldi_tpu_torch.models import build_detector
from tests.torch_port_common import (drop_weight_files, seeded_variables,
                                     tiny_cfg, tiny_vit)
from tests.torch_rcnn_oracle import build_r50_fpn_rcnn, randomize
from tests.torch_vit_oracle import build_sfp, build_vit_trunk
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def no_weights_left(tmp_path):
    yield
    drop_weight_files(tmp_path)


def r50_cfg(get_cfg):
    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    cfg.EMA.ENABLED = True
    return cfg


def vit_cfg(get_cfg):
    """ViTDet's backbone (the tiny ViT) with the oracle's heads: one RPN
    conv and the 2-FC box head, on a 224 canvas (a 14x14 grid, the
    pretraining grid, so every rel-pos table has the checkpoint's size)."""
    cfg = tiny_cfg(get_cfg)
    cfg.MODEL.BACKBONE.NAME = "build_vitdet_b_backbone"
    cfg.TPU.CANVAS = (224, 224)
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    cfg.EMA.ENABLED = True
    return cfg


def r50_state_dict(seed):
    return randomize(build_r50_fpn_rcnn(num_classes=3), seed).state_dict()


def vit_state_dict(seed):
    sd = randomize(build_vit_trunk(64, 3, 2, 16, 14, (1,), pretrain_grid=14,
                                   use_cls_token=True), seed).state_dict()
    sd.update(randomize(build_sfp(64, 256), seed + 100).state_dict())
    heads = r50_state_dict(seed + 200)
    sd.update({k: v for k, v in heads.items()
               if k.startswith(("proposal_generator.", "roi_heads."))})
    return sd


def load_both(cfg_fn, path, load_from_ema):
    """(port student, port teacher, JAX result as the port's state dict)
    after loading ``path`` from the same seeded starting weights."""
    jdet = jax_build_detector(cfg_fn(jax_get_cfg))
    variables = seeded_variables(jdet, seed=0)
    jstate = JaxTrainState(step=0, params=variables["params"],
                           frozen=variables.get("frozen", {}),
                           opt_state=None,
                           ema_params=variables["params"], model_state={},
                           ema_model_state=None)
    out = jax_load_reference_weights(jstate, str(path),
                                     load_from_ema=load_from_ema)
    want = jax_variables_to_state_dict({"params": out.params,
                                        "frozen": out.frozen})
    want_ema = jax_variables_to_state_dict({"params": out.ema_params,
                                            "frozen": out.frozen})
    cfg = cfg_fn(port_get_cfg)
    state = create_train_state(cfg, build_detector(cfg, device="cpu"),
                               jax_variables_to_state_dict(variables))
    load_reference_weights(state, str(path), load_from_ema=load_from_ema)
    return state, want, want_ema


def assert_loaded(state, want, want_ema, sd, reshaped=()):
    for module, w in ((state.student, want), (state.teacher, want_ema)):
        got = module.state_dict()
        assert set(got) == set(w)
        bad = [k for k in w if not torch.equal(got[k], w[k])]
        assert not bad, bad[:5]
    got = state.student.state_dict()
    # every weight came from the file, in the port's layout: as stored but
    # fc1 and the ``reshaped`` keys
    assert set(got) <= set(sd)
    assert {k for k in got if got[k].shape != sd[k].shape} == set(reshaped)
    assert all(torch.equal(got[k], torch.as_tensor(sd[k]).float())
               for k in got if k not in reshaped
               and k != "roi_heads.box_head.fc1.weight")
    fc1 = torch.as_tensor(sd["roi_heads.box_head.fc1.weight"]).float()
    assert not torch.equal(got["roi_heads.box_head.fc1.weight"], fc1)
    assert torch.equal(got["roi_heads.box_head.fc1.weight"],
                       fc1.reshape(1024, 256, 7, 7).permute(0, 2, 3, 1)
                       .reshape(1024, -1))


@pytest.mark.parametrize("load_from_ema", [True, False])
def test_aldi_pth_matches_jax(tmp_path, load_from_ema):
    model, ema = r50_state_dict(1), r50_state_dict(2)
    path = tmp_path / "aldi.pth"
    torch.save({"model": model,
                "ema": {f"model.{k}": v for k, v in ema.items()},
                "iteration": 100}, path)
    state, want, want_ema = load_both(r50_cfg, path, load_from_ema)
    sd = ema if load_from_ema else model
    assert_loaded(state, want, want_ema, sd)


def test_d2_pkl_matches_jax(tmp_path):
    sd = {k: v.numpy() for k, v in r50_state_dict(3).items()}
    path = tmp_path / "model_final.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": sd, "__author__": "synthetic"}, f)
    state, want, want_ema = load_both(r50_cfg, path, True)
    assert_loaded(state, want, want_ema, sd)


@pytest.mark.parametrize("suffix", [".pth", ".pkl"])
def test_vitdet_reference_matches_jax(tmp_path, suffix):
    """The ViT trunk and SFP of the oracle: ``pos_embed`` [1, 197, D] with
    the class token becomes the port's [1, 14, 14, D]."""
    sd = vit_state_dict(4)
    assert sd["backbone.net.pos_embed"].shape == (1, 197, 64)
    path = tmp_path / f"vitdet{suffix}"
    if suffix == ".pth":
        torch.save(sd, path)
    else:
        with open(path, "wb") as f:
            pickle.dump({"model": {k: v.numpy() for k, v in sd.items()}}, f)
    with tiny_vit():
        state, want, want_ema = load_both(vit_cfg, path, True)
    assert_loaded(state, want, want_ema, sd, ["backbone.net.pos_embed"])
    got = state.student.state_dict()["backbone.net.pos_embed"]
    assert torch.equal(got, sd["backbone.net.pos_embed"][:, 1:].reshape(
        1, 14, 14, 64))


def test_checkpointer_round_trips(tmp_path):
    """The port's own file: student, teacher, momentum, iteration and the
    trainer state come back bit for bit."""
    cfg = r50_cfg(port_get_cfg)
    cfg.MODEL.RESNETS.DEPTH = 26
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det)
    with torch.no_grad():
        for p in state.teacher.parameters():
            p.mul_(0.5)
    for p in state.student.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.step = 17
    ckpt = Checkpointer(str(tmp_path))
    path = ckpt.save(state, extra={"best_ap50": {"val": 12.5}})
    assert path.endswith("model_0000017.pth") and ckpt.latest_path() == path
    other = create_train_state(cfg, build_detector(cfg, device="cpu"))
    assert ckpt.resume_or_load(other, "", resume=True) == {
        "best_ap50": {"val": 12.5}}
    assert other.step == 17
    for a, b in ((state.student, other.student),
                 (state.teacher, other.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    mom = [state.optimizer.state[p]["momentum_buffer"]
           for p in state.student.parameters() if p.requires_grad]
    mom2 = [other.optimizer.state[p]["momentum_buffer"]
            for p in other.student.parameters() if p.requires_grad]
    assert len(mom) == len(mom2) > 0
    assert all(torch.equal(x, y) for x, y in zip(mom, mom2))
    # a fresh start from the port's own file takes its EMA entry
    fresh = create_train_state(cfg, build_detector(cfg, device="cpu"))
    load_reference_weights(fresh, path, load_from_ema=True)
    want = state.teacher.state_dict()
    assert all(torch.equal(fresh.student.state_dict()[k], want[k])
               for k in want)
    assert np.isclose(float(torch.load(path, weights_only=True)[
        "iteration"]), 17)


class _Extra:
    """An object a reference ``.pth`` may pickle beside its tensors."""

    def __init__(self, note):
        self.note = note


@pytest.mark.parametrize("extra", [False, True])
def test_torch_files_unpickle_in_full_only_when_needed(tmp_path, extra,
                                                       caplog):
    """Tensors and plain containers load with ``weights_only=True`` and no
    warning; a file that pickles another object fails that, is unpickled
    in full and says so in the log. Both give the same tensors."""
    import logging

    from aldi_tpu_torch.engine.checkpoint_convert import load_torch_state_dict

    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    path = str(tmp_path / "ref.pth")
    torch.save({"model": sd, **({"cfg": _Extra("x")} if extra else {})},
               path)
    logger = logging.getLogger("test_torch_files")
    with caplog.at_level(logging.WARNING, logger="test_torch_files"):
        got = load_torch_state_dict(path, logger)
    assert torch.equal(got["model"]["w"], sd["w"])
    assert ("unpickling it in full" in caplog.text) == extra
    assert isinstance(got.get("cfg"), _Extra) == extra
