"""Weights of the JAX detector -> the port's state dict.

``jax_variables_to_state_dict`` takes the JAX R-CNN detector's
``{"params", "frozen"}`` trees (nested dicts of numpy arrays) and returns a
state dict for ``models.rcnn.RCNN``, whose names follow detectron2:

- conv kernels HWIO -> OIHW; Dense kernels [in, out] -> Linear [out, in]
  (the box head's ``fc1`` keeps the (h, w, c) input order of the JAX
  package, so it needs no permutation);
- FrozenBN arrays of the ``frozen`` collection -> buffers.

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


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_name(path) -> str:
    top, leaf = path[0], path[-1]
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
    leaf = "weight" if leaf == "kernel" else leaf
    if top == "fpn":  # lateral{s} / output{s}
        return f"backbone.fpn_{path[1]}.{leaf}"
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
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            out[_port_name(path)] = torch.from_numpy(np.ascontiguousarray(a))
    return out
