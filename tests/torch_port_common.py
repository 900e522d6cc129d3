"""Shared fixtures of the ``test_torch_port_*`` tests: one tiny R-CNN config
for both packages, seeded numpy weights in the JAX package's variable tree,
and their conversion into the port's state dict.

The tiny config is the one of ``tests/test_rcnn_forward.py``: ResNet depth
26 (one block per stage), canvas 128, 3 classes, RPN top-k 64/32. The tiny
ViTDet is the one of ``tests/test_backbones.py:22-42``: the ViTDet head
config (LN conv box head, two RPN convs) over a ViT of embed 64, depth 3,
2 heads, global block 1, patched into both packages' ``VIT_CONFIGS["b"]``
by ``tiny_vit``.
"""

import contextlib

import jax
import numpy as np

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu_torch.config import get_cfg as torch_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict


def tiny_cfg(get_cfg):
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.RESNETS.DEPTH = 26
    cfg.TPU.CANVAS = (128, 128)
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    return cfg


def tiny_cfgs():
    """The same tiny config as (JAX package cfg, port cfg)."""
    return tiny_cfg(jax_get_cfg), tiny_cfg(torch_get_cfg)


def seeded_variables(det, seed=0):
    """The JAX detector's {"params", "frozen"} trees filled from a numpy
    seed: kernels with std gain/sqrt(fan_in), small random biases, and
    FrozenBN statistics away from the identity so the folded-BN arithmetic
    is exercised. The gains keep activations O(1) (the stem sees pixels of
    about +-128), keep box deltas small so proposals stay varied, and
    spread the class logits so detection scores are well apart and both
    packages rank them the same."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(det.init_variables, jax.random.PRNGKey(0))
    gains = {"stem_conv1": 1 / 128, "anchor_deltas": 0.1, "bbox_pred": 0.1,
             "cls_score": 3.0}

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf = names[-1]
        if leaf == "kernel":
            # fan in: all but the last axis, but the head-major qkv kernel
            # [C, 3, heads, head_dim] contracts its first axis only
            fan = s.shape[0] if names[-2] == "qkv" else np.prod(s.shape[:-1])
            std = gains.get(names[-2], 1.0) / np.sqrt(fan)
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if leaf in ("weight", "running_var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def tiny_detectors(seed=0):
    """(JAX detector, its variables, port detector on the CPU) with the same
    weights."""
    from aldi_tpu_torch.models import build_detector

    jcfg, tcfg = tiny_cfgs()
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed)
    tdet = build_detector(tcfg, device="cpu")
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    return jdet, variables, tdet


def tiny_images(b=2, canvas=(128, 128), seed=0):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (b, *canvas, 3)).astype(np.float32)
    sizes = np.asarray([[canvas[0], canvas[1]], [canvas[0] - 28,
                                                 canvas[1] - 8]][:b], np.int32)
    return images, sizes


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64)), initial=0.0))


VIT_TINY = dict(embed_dim=64, depth=3, num_heads=2, drop_path_rate=0.1,
                global_blocks=(1,))


@contextlib.contextmanager
def tiny_vit(**overrides):
    """Both packages' ``VIT_CONFIGS["b"]`` set to the tiny ViT (with
    ``overrides``) for the duration; the JAX package reads it whenever a
    detector's module is applied or traced."""
    from aldi_tpu.models import vit as jax_vit
    from aldi_tpu_torch.models import vit as port_vit

    saved = jax_vit.VIT_CONFIGS["b"], port_vit.VIT_CONFIGS["b"]
    jax_vit.VIT_CONFIGS["b"] = port_vit.VIT_CONFIGS["b"] = dict(
        VIT_TINY, **overrides)
    try:
        yield
    finally:
        jax_vit.VIT_CONFIGS["b"], port_vit.VIT_CONFIGS["b"] = saved


def vitdet_head_config(cfg):
    """The ViTDet-B head config of ``configs/Base-RCNN-VitDetB.yaml`` (with
    two box-head convs instead of four) on a tiny cfg."""
    cfg.MODEL.BACKBONE.NAME = "build_vitdet_b_backbone"
    cfg.MODEL.ROI_BOX_HEAD.NORM = "LN"
    cfg.MODEL.ROI_BOX_HEAD.NUM_CONV = 2
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 1
    cfg.MODEL.RPN.CONV_DIMS = [-1, -1]
    return cfg

