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
  ``rpn_head/conv{i}``;
- the ConvNeXt (``backbone/downsample{i}_{conv,norm}``,
  ``stage{i}_block{j}/{dwconv,norm,pwconv1,pwconv2,gamma}``,
  ``out_norm{i}``) -> the reference's ``backbone.bottom_up.
  {downsample_layers.{i}.{slot},stages.{i}.{j}.*,norm{i}}`` (slot 0 the
  conv for i = 0, the norm after), the depthwise kernel [7, 7, 1, C] ->
  [C, 1, 7, 7];
- the discriminators of domain alignment: ``img_align/conv{i}``,
  ``img_align/linear``, ``ins_align/linear{i}``, ``ins_align/linear_out``;
- YOLOv5 (``b{i}``, ``n{i}``, ``detect{i}``): the JAX path joined with
  dots, its BatchNorm ``scale`` -> ``weight`` and the ``batch_stats``
  collection's ``mean``/``var`` -> the ``running_mean``/``running_var``
  buffers;
- Deformable DETR (a tree with ``level_embed``): the official layout
  (``models/detr.py``): the R50 under torchvision's names in
  ``backbone.0.body``, ``input_proj{i}[_norm]`` -> ``input_proj.{i}.
  {0,1}``, ``enc{i}``/``dec{i}`` -> ``transformer.{encoder,decoder}.
  layers.{i}`` (``ffn/linear{1,2}`` -> ``linear{1,2}``, ``ffn/norm`` ->
  ``norm2`` in the encoder and ``norm3`` in the decoder), flax's attention
  ``query``/``key``/``value`` kernels [C, heads, hd] and biases packed into
  ``in_proj_weight`` [3C, C] and ``in_proj_bias``, ``out`` [heads, hd, C]
  -> ``out_proj``; the heads ``class_embed``/``bbox_embed/l{j}`` (shared:
  index 0; ``class_embed{i}`` under box refinement; ``_enc``: index
  DEC_LAYERS), ``row_embed``/``col_embed`` -> ``backbone.1.*``.

The same function converts a JAX ``TrainState``'s EMA teacher, given
``{"params": state.ema_params, "frozen": state.frozen}`` (the teacher
shares the student's FrozenBN statistics); ``engine.train_step.
create_train_state(cfg, det, weights, teacher_weights)`` takes both.

Reference checkpoints (``aldi_tpu/engine/checkpoint_convert.py:19-33,
329-397,419-482`` for the R-CNN and ViTDet families): a torch ``.pth`` or a
detectron2 zoo ``.pkl`` already carries the port's (detectron2's) names, so
``reference_state_dict_to_port`` converts only the layouts the port keeps
differently: the box head's ``fc1`` input from detectron2's channel-major
(c, h, w) flattening to (h, w, c), and a ViT ``pos_embed`` stored as tokens
[1, p*p (+1 class token), D] to the grid [1, p, p, D]; a ConvNeXt's names
and layouts are the reference's; a YOLOv5 file carries ultralytics'
``model.{idx}.*`` names (``yolo_reference_names``); an official
Deformable-DETR file carries the port's names, its R50 also accepted under
torchvision's bare ImageNet names (``conv1.weight``, ``layer1.0...``), and
its shared heads' duplicates ``class_embed.{i}``/``bbox_embed.{i}`` beyond
index 0 are left unused. The discriminators are
not read from a reference file (``aldi_tpu/engine/checkpoint_convert.py:
172-174`` skips them too): they keep their initial weights. Loading is
non-strict, as detectron2's: missing, unused and shape-mismatched keys are
logged and skipped.
"""

import pickle
from typing import Dict

import numpy as np
import torch

# JAX top-level module -> the port's module path
_TOP = {
    "rpn_head": "proposal_generator.rpn_head",
    "box_head": "roi_heads.box_head",
    "box_predictor": "roi_heads.box_predictor",
}
# domain discriminators: not read from reference files
_DISCRIMINATORS = ("img_align.", "ins_align.")
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
# YOLOv5's leaves, its BatchNorm statistics (``batch_stats``) included
_YOLO_LEAF = {**_LEAF, "mean": "running_mean", "var": "running_var"}


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


def _convnext_name(path) -> str:
    mod, leaf = path[1], _LEAF.get(path[-1], path[-1])
    base = "backbone.bottom_up"
    if mod.startswith("downsample"):  # downsample{i}_{conv,norm}
        i, kind = mod[len("downsample"):].split("_")
        slot = int((kind == "conv") == (i != "0"))
        return f"{base}.downsample_layers.{i}.{slot}.{leaf}"
    if mod.startswith("out_norm"):
        return f"{base}.norm{mod[len('out_norm'):]}.{leaf}"
    stage, block = mod[len("stage"):].split("_block")
    sub = "" if path[2] == "gamma" else f".{leaf}"
    return f"{base}.stages.{stage}.{block}.{path[2]}{sub}"


def _is_yolo(top: str) -> bool:
    """A YOLOv5 module name: ``b{i}``, ``n{i}`` or ``detect{i}``."""
    return (top[0] in "bn" and top[1:].isdigit()) or (
        top.startswith("detect") and top[len("detect"):].isdigit())


def _port_name(path) -> str:
    top, leaf = path[0], path[-1]
    if _is_yolo(top):  # the port keeps the JAX names: a join
        return ".".join(path[:-1] + (_YOLO_LEAF.get(leaf, leaf),))
    if top == "backbone" and (path[1] == "pos_embed" or path[1].startswith(
            ("patch_embed", "block"))):
        return _vit_name(path)
    if top == "backbone" and path[1].startswith(
            ("downsample", "stage", "out_norm")):
        return _convnext_name(path)
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
    if top in ("img_align", "ins_align"):
        return f"{top}.{path[1]}.{leaf}"
    raise KeyError(f"no counterpart in the port for {'/'.join(path)}")


_DETR_BODY = "backbone.0.body"


def _detr_head(top: str, n_dec: int) -> str:
    """``class_embed``/``bbox_embed`` (shared), ``...{i}`` or ``..._enc``
    -> its index in the port's head list."""
    for base in ("class_embed", "bbox_embed"):
        if top.startswith(base):
            suffix = top[len(base):]
            idx = n_dec if suffix == "_enc" else int(suffix or 0)
            return f"{base}.{idx}"
    raise KeyError(top)


def _detr_name(path, n_dec: int) -> str:
    top, leaf = path[0], _LEAF.get(path[-1], path[-1])
    if top == "backbone":  # stem_conv1[_norm] or res{s}_block{b}/conv{i}...
        mod = path[1]
        if mod.startswith("stem_conv1"):
            return (f"{_DETR_BODY}.bn1.{leaf}" if mod.endswith("_norm")
                    else f"{_DETR_BODY}.conv1.weight")
        stage, block = mod.split("_block")
        base = f"{_DETR_BODY}.layer{int(stage[len('res'):]) - 1}.{block}"
        conv = path[2]
        if conv.startswith("shortcut"):
            slot = "1" if conv.endswith("_norm") else "0"
            return f"{base}.downsample.{slot}.{leaf}"
        if conv.endswith("_norm"):
            return f"{base}.bn{conv[len('conv')]}.{leaf}"
        return f"{base}.{conv}.weight"
    if top.startswith("input_proj"):
        i = top[len("input_proj")]
        return f"input_proj.{i}.{int(top.endswith('_norm'))}.{leaf}"
    if top == "level_embed":
        return "transformer.level_embed"
    if top in ("row_embed", "col_embed"):
        return f"backbone.1.{top}.weight"
    if top == "query_embed":
        return "query_embed.weight"
    if top in ("reference_points", "enc_output", "enc_output_norm",
               "pos_trans", "pos_trans_norm"):
        return f"transformer.{top}.{leaf}"
    if top.startswith("class_embed"):
        return f"{_detr_head(top, n_dec)}.{leaf}"
    if top.startswith("bbox_embed"):
        return f"{_detr_head(top, n_dec)}.layers.{path[1][1:]}.{leaf}"
    kind = {"enc": "encoder", "dec": "decoder"}[top[:3]]
    base = f"transformer.{kind}.layers.{top[3:]}"
    if path[1] == "ffn":
        sub = path[2]
        if sub == "norm":
            sub = "norm2" if kind == "encoder" else "norm3"
        return f"{base}.{sub}.{leaf}"
    if path[1] == "self_attn" and kind == "decoder":
        return f"{base}.self_attn.{path[2]}.{path[-1]}"  # packed below
    return f"{base}.{'.'.join(path[1:-1])}.{leaf}"


def _pack_attention(out: dict) -> None:
    """flax attention projections (``...self_attn.{query,key,value,out}.
    {kernel,bias}``, as ``_detr_name`` leaves them) -> ``in_proj_weight``,
    ``in_proj_bias`` and ``out_proj``, in place."""
    for name in [k for k in out if k.endswith("self_attn.query.kernel")]:
        base = name[:-len("query.kernel")]
        qkv = [out.pop(f"{base}{p}.kernel") for p in ("query", "key",
                                                      "value")]
        bias = [out.pop(f"{base}{p}.bias") for p in ("query", "key",
                                                     "value")]
        out[f"{base}in_proj_weight"] = torch.cat(
            [k.reshape(k.shape[0], -1).T for k in qkv]).contiguous()
        out[f"{base}in_proj_bias"] = torch.cat([b.reshape(-1) for b in bias])
        k = out.pop(f"{base}out.kernel")
        out[f"{base}out_proj.weight"] = k.reshape(-1, k.shape[-1]).T \
            .contiguous()
        out[f"{base}out_proj.bias"] = out.pop(f"{base}out.bias")


def jax_variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``{"params": tree, "frozen": tree}`` (the R-CNN families and
    Deformable DETR) or ``{"params": tree, "batch_stats": tree}`` (YOLOv5)
    -> ``{name: float32 tensor}``."""
    params = variables.get("params", {})
    if "level_embed" in params:
        n_dec = sum(k.startswith("dec") and k[3:].isdigit() for k in params)
        out = {}
        for coll in ("params", "frozen"):
            for path, arr in _flatten(variables.get(coll, {})):
                a = np.asarray(arr, dtype=np.float32)
                if path[-1] == "kernel" and a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)
                elif path[-1] == "kernel" and a.ndim == 2:
                    a = a.T
                out[_detr_name(path, n_dec)] = torch.from_numpy(
                    np.ascontiguousarray(a))
        _pack_attention(out)
        return out
    out = {}
    for coll in ("params", "frozen", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})):
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


# ------------------------------------------------------ reference files
def load_torch_state_dict(path: str, logger=None):
    """A torch checkpoint file as saved (a state dict, ``{model, ema,
    ...}``, ...), read with ``weights_only=True``: tensors and plain
    containers only. A file that holds other objects (a reference ``.pth``
    with pickled extras, a whole module) fails that and is then unpickled
    in full, with a log line: load such files only from sources you
    trust."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if logger:
            logger.warning(f"{path} holds more than tensors "
                           f"({str(e).splitlines()[0]}); unpickling it in "
                           f"full")
        return torch.load(path, map_location="cpu", weights_only=False)


def load_d2_pkl_state_dict(path: str) -> dict:
    """A detectron2 model-zoo ``.pkl``: ``{"model": {name: ndarray}, ...}``
    (or the bare dict)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    return data["model"] if "model" in data else data


def _reference_layout(name: str, t: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """One reference tensor in the port's layout for ``name``."""
    if name.endswith("pos_embed") and t.ndim == 3 and target.ndim == 4:
        # [1, tokens (+ class token), D] -> the grid [1, p, p, D]; the
        # class token is never used downstream
        p = target.shape[1] * target.shape[2]
        if t.shape[1] == p + 1:
            t = t[:, 1:]
        if t.shape[1] == p:
            t = t.reshape(target.shape)
        return t
    if (name == "roi_heads.box_head.fc1.weight" and t.ndim == 2
            and t.shape == target.shape and t.shape[1] % 49 == 0):
        # the input of the first FC: detectron2 flattens the 7x7 pooled
        # (or conv) features channel-major, the port (h, w, c)
        out_dim, in_dim = t.shape
        t = (t.reshape(out_dim, in_dim // 49, 7, 7).permute(0, 2, 3, 1)
             .reshape(out_dim, in_dim))
    return t


def yolo_reference_names(name: str):
    """A port YOLOv5 state-dict name -> the ultralytics names it may have
    in a reference file (port of ``aldi_tpu/engine/checkpoint_convert.py:
    178-212``): module indices of the v5 yaml layout (``b4.m0.cv1.bn.
    weight`` -> ``4.m.0.cv1.bn.weight``, ``detect{i}`` -> ``24.m.{i}``),
    under the three wrapper prefixes: plain ultralytics (``model.``),
    stripped, and double-wrapped (``model.model.``)."""
    top, *rest = name.split(".")
    if top.startswith("detect"):
        stem = f"24.m.{top[len('detect'):]}.{rest[-1]}"
    else:
        segs = [f"m.{p[1:]}" if p[0] == "m" and p[1:].isdigit() else p
                for p in rest]
        stem = ".".join([top[1:]] + segs)
    return [f"model.{stem}", stem, f"model.model.{stem}"]


def reference_state_dict_to_port(sd: dict, target: Dict[str, torch.Tensor],
                                 logger=None, convert_layouts=True
                                 ) -> Dict[str, torch.Tensor]:
    """A detectron2-named state dict (tensors or numpy arrays) -> a state
    dict over ``target``'s keys (the port module's ``state_dict()``): each
    key the reference has, in the port's layout (``convert_layouts=False``:
    already in it, as in the port's own checkpoints) and ``target``'s
    dtype; each other key keeps ``target``'s tensor. A reference file's
    discriminators (``convert_layouts``) are skipped. Missing, unused and
    shape-mismatched keys are logged and skipped."""
    out, used, missing, mismatched = {}, set(), [], []
    for name, want in target.items():
        if convert_layouts and name.startswith(_DISCRIMINATORS):
            out[name] = want
            continue
        key = name
        if convert_layouts and _is_yolo(name.split(".", 1)[0]):
            key = next((k for k in yolo_reference_names(name) if k in sd),
                       name)
        elif (convert_layouts and name.startswith(_DETR_BODY + ".")
              and name not in sd):
            key = name[len(_DETR_BODY) + 1:]  # torchvision's ImageNet names
        if key not in sd:
            missing.append(name)
            out[name] = want
            continue
        v = sd[key]
        t = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(v)))
        if convert_layouts:
            t = _reference_layout(name, t, want)
        if t.shape != want.shape:
            mismatched.append(f"{name}: ckpt {tuple(t.shape)} vs model "
                              f"{tuple(want.shape)}")
            out[name] = want
            continue
        out[name] = t.to(want.dtype).contiguous()
        used.add(key)
    if logger:
        unused = [k for k in sd if k not in used]
        if missing:
            logger.info(f"checkpoint: {len(missing)} model keys not found "
                        f"in checkpoint (first 10: {missing[:10]})")
        if mismatched:
            logger.info(f"checkpoint: shape mismatches skipped: {mismatched}")
        if unused:
            logger.info(f"checkpoint: {len(unused)} checkpoint keys unused "
                        f"(first 10: {unused[:10]})")
    return out
