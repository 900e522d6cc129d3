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



def register_synthetic_both(root, prefix, splits=None):
    """``tests/synthetic_data.py`` splits written under ``root`` and
    registered as ``{prefix}_{split}`` in both packages' catalogs (each
    package keeps its own registry). ``splits``: {split: (images, seed,
    fog)}. Returns the names."""
    from aldi_tpu.data import catalog as jax_catalog
    from aldi_tpu_torch.data import catalog as port_catalog
    from tests.synthetic_data import make_synthetic_coco

    splits = splits or {"train": (8, 0, False), "val": (4, 1, False),
                        "unlabeled": (8, 2, True)}
    names = {}
    for split, (n, seed, fog) in splits.items():
        name = f"{prefix}_{split}"
        jp, ir = make_synthetic_coco(str(root), name, n, seed=seed, fog=fog)
        for cat in (jax_catalog, port_catalog):
            if name not in cat.DatasetCatalog:
                cat.register_coco_instances(name, {}, jp, ir)
        names[split] = name
    return names


def loader_cfg(cfg, names):
    """The tiny config's input sizes for the 96x128 synthetic images on the
    128 canvas, with ``names``' datasets."""
    cfg.INPUT.MIN_SIZE_TRAIN = (96, 112)
    cfg.INPUT.MAX_SIZE_TRAIN = 128
    cfg.INPUT.MIN_SIZE_TEST = 96
    cfg.INPUT.MAX_SIZE_TEST = 128
    cfg.TPU.MAX_GT = 8
    cfg.TPU.DATA_THREADS = 2
    cfg.DATASETS.TRAIN = (names["train"],)
    cfg.DATASETS.UNLABELED = (names["unlabeled"],)
    cfg.DATASETS.TEST = (names["val"],)
    return cfg


def drop_weight_files(root):
    """Delete the ``.pth`` and ``.pkl`` files under ``root``: a test's
    checkpoints of a full-width ResNet take hundreds of MB each, and pytest
    keeps the temporary directories of its last runs."""
    import pathlib

    for pattern in ("*.pth", "*.pkl"):
        for path in pathlib.Path(root).rglob(pattern):
            path.unlink()


@contextlib.contextmanager
def teacher_ctx_from_jax(det, jdet, variables, images, sizes, key):
    """For the duration, ``det.forward_teacher_ctx`` runs the port's teacher
    pass, checks its pseudo-labels against the JAX package's on the same
    weights (``valid`` and ``classes`` equal, boxes within 1e-3 px) and then
    returns the JAX package's context, pseudo-labels and metrics (``key``:
    the JAX step's teacher key, ``split(rng, 10)[0]``). The low-quality
    anchor match tests IoU equality, so pseudo-labels one float32 ulp apart
    can label tied anchors differently (large anchors over small boxes tie
    often): a whole step is compared with its teacher's discontinuity
    taken out, each side on the same pseudo-labels."""
    import jax.numpy as jnp
    import torch

    from aldi_tpu_torch.structures import Instances

    cfg = det.cfg
    threshold = cfg.DOMAIN_ADAPT.TEACHER.THRESHOLD
    ctx, pseudo, metrics = jax.jit(
        lambda v, im, sz: jdet.forward_teacher_ctx(
            v, im, sz, key, threshold=threshold, max_gt=cfg.TPU.MAX_GT))(
        jax.tree_util.tree_map(jnp.asarray, dict(variables)),
        jnp.asarray(images), jnp.asarray(sizes))

    def t(x):
        return torch.from_numpy(np.array(x))

    want = ({k: [t(f) for f in v] if k == "feats" else t(v)
             for k, v in ctx.items() if v is not None},
            Instances(t(pseudo.boxes), t(pseudo.classes), t(pseudo.valid),
                      t(pseudo.scores)),
            {k: t(v) for k, v in metrics.items()})
    own = det.forward_teacher_ctx

    def from_jax(*args, **kwargs):
        _, got, _ = own(*args, **kwargs)
        w = want[1]
        m = w.valid
        assert torch.equal(got.valid, m) and torch.equal(got.classes[m],
                                                         w.classes[m])
        assert max_err(got.boxes[m].numpy(), w.boxes[m].numpy()) <= 1e-3
        return want

    det.forward_teacher_ctx = from_jax
    try:
        yield want
    finally:
        del det.forward_teacher_ctx


ALDI_YOLO = "configs/cityscapes/ALDI-Yolo-Cityscapes.yaml"


def yolo_cfg(get_cfg, **overrides):
    """The ALDI-Yolo recipe (``configs/cityscapes/ALDI-Yolo-Cityscapes.yaml``)
    cut to the sizes of ``tests/test_yolo.py``: yolov5n multiples (0.33,
    0.25), 3 classes, canvas 128, MAX_GT 8, 10 detections per image, in
    float32, without warmup; ``overrides``: {"A.B": value}."""
    cfg = get_cfg()
    cfg.merge_from_file(ALDI_YOLO)
    cfg.MODEL.YAML = "yolov5://yolov5n.yaml"
    cfg.MODEL.YOLO.NUM_CLASSES = 3
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.SOLVER.WARMUP_ITERS = 0
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def yolo_variables(jdet, seed=0):
    """The JAX YOLO detector's {"params", "batch_stats"} filled from a numpy
    seed: kernels with std 1/sqrt(fan_in) (the heads' 0.5), BatchNorm
    scales and running variances in 0.5..1.5, small biases and running
    means, so that eval mode normalizes by statistics away from the
    identity."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jdet.init_variables, jax.random.PRNGKey(0))

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf = names[-1]
        if leaf == "kernel":
            gain = 0.5 if names[-2].startswith("detect") else 1.0
            std = gain / np.sqrt(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


ALDI_DETR = "configs/cityscapes/ALDI-Best-DETR-Cityscapes.yaml"


def detr_cfg(get_cfg, **overrides):
    """The ALDI-Best-DETR recipe (``configs/cityscapes/ALDI-Best-DETR-
    Cityscapes.yaml``) cut to the sizes of ``tests/test_detr.py:12``: 2 + 2
    layers, d_model 64, FFN 128, 4 heads, 20 queries, 3 classes, canvas
    128, MAX_GT 8, 10 detections per image, no weight file, without warmup
    and (so that both packages compute the same function) without dropout;
    ``overrides``: {"A.B": value}."""
    cfg = get_cfg()
    cfg.merge_from_file(ALDI_DETR)
    cfg.MODEL.WEIGHTS = ""
    dd = cfg.MODEL.DEFORMABLE_DETR
    dd.NUM_CLASSES = 3
    t = dd.TRANSFORMER
    t.ENC_LAYERS = t.DEC_LAYERS = 2
    t.NUM_QUERIES = 20
    t.HIDDEN_DIM = 64
    t.DIM_FEEDFORWARD = 128
    t.NHEADS = 4
    t.DROPOUT = 0.0
    cfg.TPU.CANVAS = (128, 128)
    cfg.TPU.MAX_GT = 8
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    cfg.SOLVER.WARMUP_ITERS = 0
    for key, value in overrides.items():
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


def detr_variables(jdet, seed=0):
    """The JAX DETR detector's {"params", "frozen"} filled from a numpy
    seed as ``seeded_variables`` fills them (the stem's gain 1/128, the
    class heads' 3, so that scores are well apart), with the embeddings
    (``level_embed``, ``query_embed``, the learned position tables) N(0, 1)
    as the JAX initializers draw them."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jdet.init_variables, jax.random.PRNGKey(0))

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf = names[-1]
        if leaf == "kernel":
            gain = (1 / 128 if names[-2] == "stem_conv1" else
                    3.0 if names[-2].startswith("class_embed") else 1.0)
            std = gain / np.sqrt(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * std).astype(np.float32)
        if leaf in ("level_embed", "query_embed", "row_embed", "col_embed"):
            return rng.standard_normal(s.shape).astype(np.float32)
        if leaf in ("weight", "running_var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))
