"""ViTDet-L (``build_vitdet_l_backbone``, ``configs/Base-RCNN-VitDetL.yaml``)
in the port, on the CPU.

- Weights: a detectron2-named ViT-L state dict (the names and layouts of
  the published ``model_final_6146ed.pkl`` that the YAML names: the
  ``pos_embed`` as 197 tokens with the class token, the box head's fc1
  input channel-major) maps onto every parameter and buffer of the port's
  full-width ViTDet-L detector at the Cityscapes canvas 1024x2048: all 24
  blocks, their relative-position tables at the model's sizes. The tensors
  are stride-0 zeros but for the two whose layout the converter changes,
  which are checked value for value. With the tables
  of the file's 1024x1024 pretraining, the four global blocks' rel_pos_w
  (127 rows against the 2048-wide canvas's 255) are skipped as shape
  mismatches, as the JAX package's loader skips them.
- Serving: the tiny ViT (``tests/torch_port_common.py`` ``VIT_TINY``, with
  two global blocks) built through the ``"l"`` entry in both packages
  (``VIT_CONFIGS["l"]`` patched for the module, as ``tiny_vit`` patches
  ``"b"``) against the JAX detector's jitted ``forward_inference``: boxes
  1e-3 px and scores 1e-5 where valid, classes and validity exactly.
"""

import contextlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models import vit as jax_vit
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.config import resolve_canvas
from aldi_tpu_torch.engine.checkpoint_convert import (
    jax_variables_to_state_dict, reference_state_dict_to_port)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models import vit as port_vit
from aldi_tpu_torch.models.rcnn import RCNN
from tests.torch_port_common import (VIT_TINY, max_err, seeded_variables,
                                     tiny_cfg, tiny_images,
                                     vitdet_head_config)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

VITL = "configs/cityscapes/ALDI-Best-ViTL-Cityscapes.yaml"
GLOBAL_BLOCKS = (5, 11, 17, 23)


@contextlib.contextmanager
def tiny_vit_l():
    """Both packages' ``VIT_CONFIGS["l"]`` set to the tiny ViT with two
    global blocks (1 and 3 of 4) for the duration."""
    saved = jax_vit.VIT_CONFIGS["l"], port_vit.VIT_CONFIGS["l"]
    jax_vit.VIT_CONFIGS["l"] = port_vit.VIT_CONFIGS["l"] = dict(
        VIT_TINY, depth=4, global_blocks=(1, 3), drop_path_rate=0.4)
    try:
        yield
    finally:
        jax_vit.VIT_CONFIGS["l"], port_vit.VIT_CONFIGS["l"] = saved


def vitl_module():
    """The port's RCNN of the ViTDet-L recipe at its Cityscapes canvas, on
    the meta device (shapes only: no 300M weights drawn)."""
    cfg = port_get_cfg()
    cfg.merge_from_file(VITL)
    box = cfg.MODEL.ROI_BOX_HEAD
    canvas = resolve_canvas(cfg)
    with torch.device("meta"):
        return RCNN(cfg.MODEL.ROI_HEADS.NUM_CLASSES, 3,
                    backbone_name=cfg.MODEL.BACKBONE.NAME,
                    rpn_conv_dims=tuple(cfg.MODEL.RPN.CONV_DIMS),
                    num_fc=box.NUM_FC, fc_dim=box.FC_DIM,
                    num_conv=box.NUM_CONV, conv_dim=box.CONV_DIM,
                    box_head_norm=box.NORM,
                    grid=(canvas[0] // 16, canvas[1] // 16)), canvas


def _zeros(shape, dtype=torch.float32):
    """Zeros of ``shape`` that hold one value (a stride-0 view)."""
    return torch.zeros((), dtype=dtype).expand(tuple(shape))


def published_state_dict(target, pretrain_grid=None):
    """A detectron2-named ViT-L state dict over ``target``'s names, in the
    published layouts: tensors of ``target``'s shapes, but the
    ``pos_embed`` [1, 1 + 14 * 14, 1024] with a class token and the fc1
    weight channel-major, both random. ``pretrain_grid`` (h, w): the global
    blocks' rel-pos tables at that grid instead of the model's. The rest
    are stride-0 zeros (the converter's output of them takes about 1.2 GB,
    freed when the test ends)."""
    rng = np.random.default_rng(0)
    sd = {k: _zeros(v.shape, v.dtype) for k, v in target.items()}
    if "backbone.net.pos_embed" not in target:  # a subset: tables only
        return _with_tables(sd, target, pretrain_grid)
    pos = target["backbone.net.pos_embed"]
    sd["backbone.net.pos_embed"] = torch.from_numpy(rng.standard_normal(
        (1, 1 + pos.shape[1] * pos.shape[2], pos.shape[3])).astype(
            np.float32))
    fc1 = target["roi_heads.box_head.fc1.weight"]
    sd["roi_heads.box_head.fc1.weight"] = torch.from_numpy(
        rng.standard_normal(tuple(fc1.shape)).astype(np.float32))
    return _with_tables(sd, target, pretrain_grid)


def _with_tables(sd, target, pretrain_grid):
    if pretrain_grid is not None:
        for i in GLOBAL_BLOCKS:
            for axis, size in zip("hw", pretrain_grid):
                name = f"backbone.net.blocks.{i}.attn.rel_pos_{axis}"
                sd[name] = _zeros((2 * size - 1, target[name].shape[1]))
    return sd


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def convert(sd, target):
    logger = logging.getLogger("test_torch_port_vitl")
    log = _Log()
    logger.addHandler(log)
    logger.setLevel(logging.INFO)
    try:
        return reference_state_dict_to_port(sd, target, logger), log.lines
    finally:
        logger.removeHandler(log)


def test_published_vitdet_l_names_map_every_parameter():
    module, canvas = vitl_module()
    target = module.state_dict()
    net = module.backbone.net
    assert len(net.blocks) == 24 and net.embed_dim == 1024
    assert [i for i, b in enumerate(net.blocks) if b.attn.use_kernel] == list(
        GLOBAL_BLOCKS)
    blocks = {k.split(".")[3] for k in target
              if k.startswith("backbone.net.blocks.")}
    assert blocks == {str(i) for i in range(24)}
    g = net.blocks[5].attn
    assert tuple(g.rel_pos_h.shape) == (127, 64)
    assert tuple(g.rel_pos_w.shape) == (255, 64)  # the 2048-wide canvas
    assert tuple(net.blocks[0].attn.rel_pos_h.shape) == (27, 64)  # window 14
    sd = published_state_dict(target)
    out, log = convert(sd, target)
    print("\n".join(log) or "every key used")
    assert set(out) == set(target) and not log
    for k, v in out.items():
        assert v.shape == target[k].shape and v.dtype == target[k].dtype, k
    n = sum(v.numel() for k, v in target.items() if ".net." in k)
    print(f"ViT-L trunk: {n / 1e6:.1f}M values, {len(target)} tensors")
    # the two layouts the converter changes, value for value
    tokens = sd["backbone.net.pos_embed"]
    np.testing.assert_array_equal(
        out["backbone.net.pos_embed"].numpy(),
        tokens[:, 1:].reshape(1, 14, 14, 1024).numpy())
    w = sd["roi_heads.box_head.fc1.weight"].numpy()
    got = out["roi_heads.box_head.fc1.weight"].numpy()
    c = w.shape[1] // 49
    np.testing.assert_array_equal(
        got.reshape(-1, 7, 7, c), w.reshape(-1, c, 7, 7).transpose(0, 2, 3, 1))


def test_published_pretrain_tables_of_the_global_blocks_are_skipped():
    """The file's global blocks hold 64x64 tables (1024x1024 pretraining):
    rel_pos_h fits the 1024-high canvas, rel_pos_w does not fit the 2048
    width and is skipped (logged), as in the JAX package."""
    module, _ = vitl_module()
    target = {k: v for k, v in module.state_dict().items()
              if ".attn.rel_pos_" in k}
    assert len(target) == 48
    out, log = convert(published_state_dict(target, (64, 64)), target)
    mismatched = [line for line in log if "shape mismatches" in line]
    assert len(mismatched) == 1
    for i in GLOBAL_BLOCKS:
        assert f"blocks.{i}.attn.rel_pos_w: ckpt (127, 64)" in mismatched[0]
        assert f"blocks.{i}.attn.rel_pos_h" not in mismatched[0]
    assert mismatched[0].count("rel_pos") == 4


@pytest.fixture(scope="module")
def tiny_l():
    with tiny_vit_l():
        yield


def test_tiny_vitdet_l_entry_matches_jax_inference(tiny_l):
    jcfg = vitdet_head_config(tiny_cfg(jax_get_cfg))
    tcfg = vitdet_head_config(tiny_cfg(port_get_cfg))
    for cfg in (jcfg, tcfg):
        cfg.MODEL.BACKBONE.NAME = "build_vitdet_l_backbone"
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed=2)
    tdet = build_detector(tcfg, device="cpu")
    net = tdet.module.backbone.net
    assert len(net.blocks) == 4 and [
        i for i, b in enumerate(net.blocks) if b.attn.use_kernel] == [1, 3]
    weights = jax_variables_to_state_dict(variables)
    tdet.module.load_state_dict(weights)
    images, sizes = tiny_images()
    want = [np.asarray(a) for a in jax.jit(jdet.forward_inference)(
        jax.tree_util.tree_map(jnp.asarray, dict(variables)),
        jnp.asarray(images), jnp.asarray(sizes))]
    got = [t.numpy() for t in tdet.forward_inference(
        torch.from_numpy(images), torch.from_numpy(sizes))]
    m = want[3]
    assert m.sum(1).min() > 0
    np.testing.assert_array_equal(got[3], m)
    box_err = max_err(got[0][m], want[0][m])
    score_err = max_err(got[1][m], want[1][m])
    print(f"tiny ViTDet-L forward_inference: boxes max abs err "
          f"{box_err:.3g}, scores {score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-5
    np.testing.assert_array_equal(got[2][m], want[2][m])
