"""The port's serving path as a whole against the JAX package, its config
copy, and the rules the port keeps (on the CPU).

Tolerances: the tiny ``forward_inference`` runs in float32 through every
stage of both packages, whose convolutions sum in another order, so
detection boxes (coordinates up to 128 px) are held to 1e-3 and scores to
1e-5; detections are compared only where ``valid`` is set, since top_k
orders ties and -inf padding differently in each framework.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu import config as jax_config
from aldi_tpu_torch import config as port_config
from aldi_tpu_torch.engine.export import make_serving_fn
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd
from tests.torch_port_common import (max_err, tiny_cfgs, tiny_detectors,
                                     tiny_images)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob(
    "*.yaml"))


def test_forward_inference_matches_jax():
    jdet, variables, tdet = tiny_detectors()
    images, sizes = tiny_images()
    want = [np.asarray(a) for a in jdet.forward_inference(
        variables, jnp.asarray(images), jnp.asarray(sizes))]
    before = roi_align_fwd.launches
    got = make_serving_fn(tdet)(images, sizes)
    assert roi_align_fwd.launches == before == 0  # CPU: the plain version
    assert set(got) == {"boxes", "scores", "classes", "valid"}
    assert got["classes"].dtype == torch.int32
    assert got["valid"].dtype == torch.bool
    np.testing.assert_array_equal(got["valid"].numpy(), want[3])
    m = want[3]
    assert m.sum(1).min() > 0  # every image has detections to compare
    box_err = max_err(got["boxes"].numpy()[m], want[0][m])
    score_err = max_err(got["scores"].numpy()[m], want[1][m])
    print(f"forward_inference: boxes max abs err {box_err:.3g}, "
          f"scores {score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-5
    np.testing.assert_array_equal(got["classes"].numpy()[m], want[2][m])


def test_serving_fn_loads_weights_and_keeps_shapes():
    _, _, tdet = tiny_detectors()
    images, sizes = tiny_images()
    first = make_serving_fn(tdet)(images, sizes)
    fn = make_serving_fn(tdet, tdet.init_variables(seed=3))
    out = fn(torch.from_numpy(images), torch.from_numpy(sizes))
    assert out["boxes"].shape == (2, 10, 4)
    assert not torch.equal(out["scores"], first["scores"])
    ok = out["valid"]
    h, w = sizes[:, 0, None], sizes[:, 1, None]
    b = out["boxes"].numpy()
    assert np.all(b[..., 2][ok] <= np.broadcast_to(w, ok.shape)[ok.numpy()])
    assert np.all(b[..., 3][ok] <= np.broadcast_to(h, ok.shape)[ok.numpy()])
    assert np.all(b[ok.numpy()] >= 0)


def test_init_variables_is_seeded():
    _, tcfg = tiny_cfgs()
    a = build_detector(tcfg, device="cpu").init_variables(seed=7)
    b = build_detector(tcfg, device="cpu").init_variables(seed=7)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_copy_matches_jax(path):
    """The port's config copy loads every shipped YAML to the same tree and
    canvas as the JAX package's."""
    want = jax_config.get_cfg()
    want.merge_from_file(str(ROOT / path))
    got = port_config.get_cfg()
    got.merge_from_file(str(ROOT / path))
    assert got.to_dict() == want.to_dict()
    assert port_config.resolve_canvas(got) == jax_config.resolve_canvas(want)
    assert str(port_config.compute_dtype(got)).split(".")[-1] == \
        np.dtype(jax_config.compute_dtype(want)).name


def test_build_detector_defaults_to_cuda(monkeypatch):
    """Without a GPU the default device raises; the port never drops to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = tiny_cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detector(tcfg)
    assert build_detector(tcfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("overrides,match", [
    # Deformable DETR is ported; a backbone other than resnet50 raises the
    # JAX package's error, with its text
    pytest.param({"MODEL.META_ARCHITECTURE": "DeformableDETR",
                  "MODEL.DEFORMABLE_DETR.BACKBONE": "resnet101"},
                 "only 'resnet50' is implemented",
                 id="MODEL.META_ARCHITECTURE-DeformableDETR"),
    # precomputed proposals are ported for the R-CNN; with another
    # meta-architecture they raise, as in the JAX package
    pytest.param({"MODEL.LOAD_PROPOSALS": True,
                  "MODEL.META_ARCHITECTURE": "DeformableDETR"},
                 "GeneralizedRCNN", id="MODEL.LOAD_PROPOSALS-DeformableDETR"),
])
def test_unported_configs_raise(overrides, match):
    _, tcfg = tiny_cfgs()
    for key, value in overrides.items():
        node = tcfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    with pytest.raises(NotImplementedError, match=match):
        build_detector(tcfg, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("MODEL.BACKBONE.NAME", "build_no_such_backbone"),
    ("MODEL.RESNETS.RES5_DILATION", 2),
])
def test_unknown_options_raise_what_jax_raises(key, value):
    """An unknown backbone and a dilated res5 under the FPN: the port
    raises the JAX package's exception type with its message. The JAX
    package raises the first where flax runs the detector's ``setup``
    (here under ``jax.eval_shape`` of ``init_variables``), the second when
    the detector is built."""
    import jax

    from aldi_tpu.models import build_detector as jax_build_detector

    jcfg, tcfg = tiny_cfgs()
    errors = []
    for cfg, build in ((jcfg, lambda c: jax.eval_shape(
            jax_build_detector(c).init_variables, jax.random.PRNGKey(0))),
            (tcfg, lambda c: build_detector(c, device="cpu"))):
        *parents, leaf = key.split(".")
        node = cfg
        for part in parents:
            node = node[part]
        node[leaf] = value
        with pytest.raises(Exception) as info:
            build(cfg)
        errors.append((type(info.value), str(info.value)))
    print(f"{key} {value}: {errors[1]}")
    assert errors[1] == errors[0]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """An AST scan of every module of the port (the interpreter here preloads
    jax, so sys.modules would prove nothing)."""
    files = sorted((ROOT / "aldi_tpu_torch").rglob("*.py"))
    names = {str(f.relative_to(ROOT / "aldi_tpu_torch")) for f in files}
    assert {"models/rcnn.py", "structures.py", "solver.py", "ops/losses.py",
            "ops/matcher.py", "ops/match_kernel.py", "ops/roi_align.py",
            "ops/roi_align_kernel.py", "data/strong_aug.py",
            "engine/train_step.py", "engine/ema.py", "engine/distill.py",
            "engine/pseudolabel.py", "models/vit.py", "ops/flash_attn.py",
            "ops/flash_attn_kernel.py", "utils/events.py", "data/catalog.py",
            "data/coco.py", "data/datasets.py", "data/transforms.py",
            "data/loader.py", "engine/coco_eval.py", "engine/evaluator.py",
            "engine/checkpoint.py", "engine/checkpoint_convert.py",
            "engine/trainer.py", "tools/train_net.py",
            "tools/efficacy.py", "ops/custom_ops.py", "engine/export.py",
            "tools/export_model.py", "models/convnext.py",
            "models/yolo.py", "models/detr.py", "parallel/__init__.py",
            "parallel/mesh.py", "data/proposals.py",
            "tools/calibrate_threshold.py", "tools/debug_pipeline.py",
            "tools/visualize_featurespace.py", "data/native.py",
            "utils/registry.py"} <= names
    banned = ("jax", "jaxlib", "flax", "aldi_tpu", "aldi_native")
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert not bad, bad
    smoke = ROOT / "chip_smoke.py"
    assert not [m for m in _imports(smoke) if m.split(".")[0] in banned]


def test_port_keeps_its_own_native_decoder():
    """No file of the port (nor ``chip_smoke.py``) names the JAX package's
    native source or its built extension: the port builds its decoder only
    from ``aldi_tpu_torch/csrc/native_decode.cpp``."""
    files = [f for f in sorted((ROOT / "aldi_tpu_torch").rglob("*"))
             if f.is_file() and f.suffix in (".py", ".cpp", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    bad = [str(f.relative_to(ROOT)) for f in files
           if any(s in f.read_text() for s in ("native/aldi_native",
                                               "aldi_native.cpp"))]
    assert not bad, bad
    assert (ROOT / "aldi_tpu_torch" / "csrc" / "native_decode.cpp").exists()
