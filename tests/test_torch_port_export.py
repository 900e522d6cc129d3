"""The port's serving artifact (``aldi_tpu_torch/engine/export.py``) on the
CPU: the counterparts of ``tests/test_export.py``, for the tiny R50-FPN and
the tiny ViTDet of ``tests/torch_port_common.py`` with the same seeded
weights as the JAX package's detector.

Tolerances: the artifact against the port's eager ``make_serving_fn``
exactly (the loaded program runs the same operations and the same plain
versions of the kernels' ops in the same order); against the JAX package's
``forward_inference`` those of ``test_forward_inference_matches_jax``:
``valid`` and ``classes`` equal, boxes within 1e-3 px and scores within
1e-5 where ``valid`` (float32 convolutions sum in another order in each
framework).
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                          make_serving_fn, save_artifact)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.ops.flash_attn_kernel import flash_attn_fwd
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd
from tests.torch_port_common import (drop_weight_files, max_err,
                                     seeded_variables, tiny_cfg, tiny_images,
                                     tiny_vit, vitdet_head_config)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

FLAGSHIP = str(Path(__file__).resolve().parents[1] / "configs" / "cityscapes"
               / "ALDI-Best-Cityscapes.yaml")
BATCH = 2
MODELS = ("r50", "vit")
KERNEL_OPS = {"r50": {"aldi_tpu_torch.roi_align_fwd.default"},
              "vit": {"aldi_tpu_torch.roi_align_fwd.default",
                      "aldi_tpu_torch.flash_attn_fwd.default"}}


def _cfgs(model):
    jcfg, tcfg = tiny_cfg(jax_get_cfg), tiny_cfg(port_get_cfg)
    if model == "vit":
        jcfg, tcfg = vitdet_head_config(jcfg), vitdet_head_config(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=MODELS)
def exported(request, tmp_path_factory):
    """One export per model: the artifact's directory, the port's detector
    with the seeded weights, the request, the port's eager outputs and the
    JAX package's."""
    model = request.param
    with tiny_vit():
        jcfg, tcfg = _cfgs(model)
        jdet = jax_build_detector(jcfg)
        variables = seeded_variables(jdet, seed=0)
        images, sizes = tiny_images(BATCH)
        want_jax = [np.asarray(a) for a in jdet.forward_inference(
            variables, jnp.asarray(images), jnp.asarray(sizes))]
        det = build_detector(tcfg, device="cpu")
        weights = jax_variables_to_state_dict(variables)
        eager = make_serving_fn(det, weights)(images, sizes)
        programs = export_inference(det, None, BATCH)
    path = tmp_path_factory.mktemp(f"serving_{model}")
    save_artifact(str(path), programs, det, tcfg, BATCH)
    yield dict(model=model, path=str(path), det=det, programs=programs,
               images=images, sizes=sizes, eager=eager, jax=want_jax)
    shutil.rmtree(path)  # ~100 MB: the tiny box head's fc1 is 12544 x 1024


def test_artifact_equals_eager_serving_fn(exported):
    """The loaded CPU program against ``make_serving_fn`` on the same
    request: every output bitwise equal; no kernel launched."""
    before = (roi_align_fwd.launches, flash_attn_fwd.launches)
    model = load_artifact(exported["path"], platform="cpu")
    got = model(exported["images"], exported["sizes"])
    assert (roi_align_fwd.launches, flash_attn_fwd.launches) == before
    want = exported["eager"]
    assert set(got) == set(want) == {"boxes", "scores", "classes", "valid"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
    m = want["valid"]
    assert m.sum(1).min() > 0  # every image has detections to compare
    err = {k: max_err(got[k][m], want[k][m]) for k in ("boxes", "scores")}
    print(f"{exported['model']} artifact vs eager: boxes max abs err "
          f"{err['boxes']:.3g}, scores {err['scores']:.3g}")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_artifact_matches_jax_forward_inference(exported):
    """The loaded CPU program against the JAX package's
    ``forward_inference`` on the same seeded weights and request."""
    got = load_artifact(exported["path"], platform="cpu")(
        exported["images"], exported["sizes"])
    boxes, scores, classes, valid = exported["jax"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    m = valid
    assert m.sum(1).min() > 0
    box_err = max_err(got["boxes"].numpy()[m], boxes[m])
    score_err = max_err(got["scores"].numpy()[m], scores[m])
    print(f"{exported['model']} artifact vs JAX forward_inference: boxes max "
          f"abs err {box_err:.3g}, scores {score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-5
    np.testing.assert_array_equal(got["classes"].numpy()[m], classes[m])


def test_exported_graph_calls_the_kernel_ops(exported):
    """The graph holds the kernels' custom ops as call nodes (not their
    plain versions inlined) and NMS's loop as ``while_loop``."""
    graph = exported["programs"]["cpu"].graph_module
    targets = {str(n.target) for gm in graph.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"}
    ops = {t for t in targets if t.startswith("aldi_tpu_torch.")}
    print(f"{exported['model']} exported graph: kernel ops {sorted(ops)}")
    assert ops == KERNEL_OPS[exported["model"]]
    assert any("while_loop" in t for t in targets)


def test_artifact_meta_contract(exported):
    det = exported["det"]
    m = load_artifact(exported["path"], platform="cpu").meta
    assert set(m) == {"format_version", "canvas", "batch_size", "num_classes",
                      "meta_architecture", "input_format", "platforms",
                      "inputs", "outputs"}
    assert tuple(m["canvas"]) == det.canvas
    assert m["batch_size"] == BATCH
    assert m["num_classes"] == det.num_classes
    assert m["platforms"] == ["cpu"]  # no card here: the CPU program only
    assert m["input_format"] == "BGR"
    assert m["inputs"]["images"]["shape"] == [BATCH, *det.canvas, 3]
    assert m["inputs"]["sizes"] == {
        "shape": [BATCH, 2], "dtype": "int32",
        "note": "valid (h, w) per image before padding"}
    assert set(m["outputs"]) == {"boxes", "scores", "classes", "valid"}


def test_missing_platform_is_loud(exported, monkeypatch):
    with pytest.raises(ValueError, match="no module for platform"):
        load_artifact(exported["path"], platform="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no module for platform 'cuda'"):
        load_artifact(exported["path"])


def test_load_without_a_card_raises(exported, monkeypatch):
    """The default platform is ``cuda``: without a card, loading raises
    unless the CPU program is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_artifact(exported["path"])
    assert load_artifact(exported["path"], platform="cpu").platform == "cpu"


def test_artifact_version_gate(exported, tmp_path):
    bad = tmp_path / "bad"
    shutil.copytree(exported["path"], bad)
    meta = json.loads((bad / "meta.json").read_text())
    meta["format_version"] = 999
    (bad / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format"):
        load_artifact(str(bad), platform="cpu")
    load_artifact(exported["path"], platform="cpu")  # original untouched


@pytest.mark.parametrize("ema", [False, True])
def test_export_model_tool_selftest(tmp_path, ema, capsys):
    """``python3 -m aldi_tpu_torch.tools.export_model --platforms cpu
    --selftest`` on the flagship YAML cut to the tiny config, from one of
    the port's checkpoints whose student and EMA teacher differ: the
    artifact equals the eager serving path of the student, or of the
    teacher with ``--ema``."""
    from aldi_tpu_torch.engine.checkpoint import Checkpointer
    from aldi_tpu_torch.engine.train_step import create_train_state
    from aldi_tpu_torch.tools import export_model

    overrides = ["MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.RESNETS.DEPTH",
                 "26", "TPU.CANVAS", "(128, 128)",
                 "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
                 "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
                 "TEST.DETECTIONS_PER_IMAGE", "10",
                 "OUTPUT_DIR", str(tmp_path / "out")]
    cfg = port_get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.merge_from_list(overrides)
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, teacher_weights=det.init_variables(
        seed=5))
    det.init_variables(seed=4)
    ckpt = Checkpointer(str(tmp_path / "ckpt")).save(state)
    weights = {"student": {k: v.clone() for k, v in
                           state.student.state_dict().items()},
               "teacher": state.teacher.state_dict()}
    outs = {k: make_serving_fn(det, sd)(*tiny_images(BATCH))
            for k, sd in weights.items()}
    assert not torch.equal(outs["student"]["scores"],
                           outs["teacher"]["scores"])
    want = outs["teacher" if ema else "student"]

    out = tmp_path / "serving"
    export_model.main(["--config-file", FLAGSHIP, "--weights", ckpt,
                       "--output", str(out), "--batch", str(BATCH),
                       "--platforms", "cpu", "--selftest"]
                      + (["--ema"] if ema else []) + overrides)
    log = capsys.readouterr().out
    print(log)
    assert "selftest OK (cpu)" in log
    got = load_artifact(str(out), platform="cpu")(*tiny_images(BATCH))
    err = max_err(got["scores"][want["valid"]], want["scores"][want["valid"]])
    print(f"export_model{' --ema' if ema else ''} artifact vs eager: scores "
          f"max abs err {err:.3g}")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    shutil.rmtree(out)
    drop_weight_files(tmp_path)
