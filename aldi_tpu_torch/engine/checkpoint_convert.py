"""Weights of the JAX detector -> the port's state dict.

``jax_variables_to_state_dict`` takes the JAX R-CNN detector's
``{"params", "frozen"}`` trees (nested dicts of numpy arrays) and returns a
state dict for ``models.rcnn.RCNN``, whose names follow detectron2:

- conv kernels HWIO -> OIHW; Dense kernels [in, out] -> Linear [out, in]
  (the box head's ``fc1`` keeps the (h, w, c) input order of the JAX
  package, so it needs no permutation);
- FrozenBN arrays of the ``frozen`` collection -> buffers;
- LayerNorm ``scale`` -> ``weight``;
- the ViTDet backbone (``backbone/patch_embed``, ``pos_embed``,
  ``block{i}/...`` -> ``backbone.net.*``; ``sfp/simfp_{i}_{sub}`` ->
  ``backbone.simfp_{i+2}.{slot}``) with the layouts of
  ``aldi_tpu/engine/checkpoint_convert.py:361-375`` undone: the head-major
  qkv kernel [C, 3, nh, hd] -> Linear [3C, C], proj [nh, hd, C] -> [C, C],
  deconv [kH, kW, in, out] -> ``ConvTranspose2d`` [in, out, kH, kW] with
  the spatial flip;
- the ViTDet heads: ``box_head/conv{i}[_norm]`` -> ``conv{i}[.norm]``,
  ``rpn_head/conv{i}``.

The same function converts a JAX ``TrainState``'s EMA teacher, given
``{"params": state.ema_params, "frozen": state.frozen}`` (the teacher
shares the student's FrozenBN statistics); ``engine.train_step.
create_train_state(cfg, det, weights, teacher_weights)`` takes both.
"""

from typing import Dict

import numpy as np
import torch

# JAX top-level module -> the port's module path
_TOP = {
    "rpn_head": "proposal_generator.rpn_head",
    "box_head": "roi_heads.box_head",
    "box_predictor": "roi_heads.box_predictor",
}
# domain discriminators: training-only, never run by inference
_TRAIN_ONLY = ("img_align", "ins_align")
# SimpleFeaturePyramid: JAX ``simfp_{i}_{sub}`` -> detectron2's Sequential
# slot in ``simfp_{i + 2}``
_SFP_SLOTS = {
    0: {"deconv1": "0", "ln": "1", "deconv2": "3", "conv1": "4",
        "norm1": "4.norm", "conv2": "5", "norm2": "5.norm"},
    1: {"deconv1": "0", "conv1": "1", "norm1": "1.norm", "conv2": "2",
        "norm2": "2.norm"},
    2: {"conv1": "0", "norm1": "0.norm", "conv2": "1", "norm2": "1.norm"},
    3: {"conv1": "1", "norm1": "1.norm", "conv2": "2", "norm2": "2.norm"},
}
_LEAF = {"kernel": "weight", "scale": "weight"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _vit_name(path) -> str:
    mod, leaf = path[1], _LEAF.get(path[-1], path[-1])
    if mod == "pos_embed":
        return "backbone.net.pos_embed"
    if mod == "patch_embed":
        return f"backbone.net.patch_embed.proj.{leaf}"
    base = f"backbone.net.blocks.{mod[len('block'):]}"
    sub = path[2]
    if sub == "attn":
        inner = path[3]
        if inner in ("rel_pos_h", "rel_pos_w"):
            return f"{base}.attn.{inner}"
        return f"{base}.attn.{inner}.{leaf}"
    if sub.startswith("mlp_"):  # mlp_fc1 / mlp_fc2
        return f"{base}.mlp.{sub[len('mlp_'):]}.{leaf}"
    return f"{base}.{sub}.{leaf}"  # norm1 / norm2


def _port_name(path) -> str:
    top, leaf = path[0], path[-1]
    if top == "backbone" and (path[1] == "pos_embed" or path[1].startswith(
            ("patch_embed", "block"))):
        return _vit_name(path)
    if top == "sfp":  # simfp_{i}_{sub}
        i, sub = int(path[1][len("simfp_")]), path[1][len("simfp_0_"):]
        return (f"backbone.simfp_{i + 2}.{_SFP_SLOTS[i][sub]}."
                f"{_LEAF.get(leaf, leaf)}")
    if top == "backbone":  # ResNet: stem_conv1[_norm] or res{s}_block{b}/...
        mod = path[1]
        if mod.startswith("stem_conv1"):
            base = "backbone.bottom_up.stem.conv1"
            return (f"{base}.norm.{leaf}" if mod.endswith("_norm")
                    else f"{base}.weight")
        stage, block = mod.split("_block")
        conv = path[2]
        base = f"backbone.bottom_up.{stage}.{block}"
        if conv.endswith("_norm"):
            return f"{base}.{conv[:-len('_norm')]}.norm.{leaf}"
        return f"{base}.{conv}.weight"
    leaf = _LEAF.get(leaf, leaf)
    if top == "fpn":  # lateral{s} / output{s}
        return f"backbone.fpn_{path[1]}.{leaf}"
    if top == "box_head" and path[1].endswith("_norm"):  # conv{i}_norm
        return f"{_TOP[top]}.{path[1][:-len('_norm')]}.norm.{leaf}"
    if top in _TOP:
        return f"{_TOP[top]}.{path[1]}.{leaf}"
    raise KeyError(f"no counterpart in the port for {'/'.join(path)}")


def jax_variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``{"params": tree, "frozen": tree}`` -> ``{name: float32 tensor}``."""
    out = {}
    for coll in ("params", "frozen"):
        for path, arr in _flatten(variables.get(coll, {})):
            if path[0] in _TRAIN_ONLY:
                continue
            a = np.asarray(arr, dtype=np.float32)
            if path[-1] == "kernel" and "deconv" in path[-2]:
                # [kH, kW, in, out] -> [in, out, kH, kW], spatially flipped
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif path[-1] == "kernel" and path[-2] == "qkv":
                a = a.reshape(a.shape[0], -1).T  # [C, 3, nh, hd] -> [3C, C]
            elif path[-1] == "kernel" and path[-2] == "proj":
                a = a.reshape(-1, a.shape[-1]).T  # [nh, hd, C] -> [C, C]
            elif path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            elif path[-2:] == ("qkv", "bias"):
                a = a.reshape(-1)  # [3, nh, hd] -> [3C]
            out[_port_name(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return out
