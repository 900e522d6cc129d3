"""Serving: the detector's inference path closed over weights, and the
serving artifact.

Port of ``aldi_tpu/engine/export.py``: ``make_serving_fn`` (``:43-58``),
``export_inference`` (``:61``), ``save_artifact`` (``:91``),
``ServingModel`` (``:128``) and ``load_artifact`` (``:145``), with the same
names, arguments, calling convention and ``meta.json``. The student
inference path (R-CNN: preprocess -> backbone -> proposals -> heads ->
score threshold -> class-aware NMS -> top-k; YOLO: preprocess -> network
-> decode -> top 2000 -> class-aware NMS -> top-k, with its BatchNorm in
eval mode, so the running statistics are constants of the graph) is
exported with ``torch.export``:

- weights are part of the exported program (no checkpoint needed at
  serving time),
- shapes are static (batch x canvas fixed at export time),
- ONE program per platform (``cpu`` and ``cuda``), each traced with the
  detector on that device. The kernels are ``torch.library`` custom ops
  (``ops/custom_ops.py``), so the graph holds them as call nodes: K2's
  forward ``aldi_tpu_torch.roi_align_fwd`` and, for ViTDet, K3a
  ``aldi_tpu_torch.flash_attn_fwd``. The ``cpu`` program runs their plain
  versions and the ``cuda`` program launches the kernels.

Loading needs ``torch`` and this package's ``aldi_tpu_torch.ops.custom_ops``
(imported here), which registers those ops and builds the kernels at their
first launch on the card; the JAX package's artifact needs only ``jax``.

Artifact layout (a directory):
    serving.<platform>.pt2   ``torch.export.save`` of the program per platform
    meta.json                canvas/batch/class-count/IO spec
"""

import json
import os

import torch
from torch import nn

from ..ops import custom_ops  # noqa: F401  (registers the kernels' ops)
from ..parallel import mesh
from ..utils.tracing import sync

__all__ = ["make_serving_fn", "export_inference", "save_artifact",
           "load_artifact", "ServingModel"]

_META_NAME = "meta.json"

# bump when the exported calling convention (inputs/outputs) changes
_FORMAT_VERSION = 2

_OUTPUTS = ("boxes", "scores", "classes", "valid")


def _module_name(platform):
    return f"serving.{platform}.pt2"


def make_serving_fn(det, weights=None):
    """Load ``weights`` (a state dict, or None to keep the detector's own)
    and return ``fn(images [B,H,W,3] f32 in 0..255, sizes [B,2] i32) ->
    dict`` with boxes [B,N,4] xyxy on the canvas, scores [B,N], classes
    [B,N] int32 and valid [B,N] bool. Inputs may be numpy arrays or tensors
    on any device; outputs stay on the detector's device. Under a profiler
    each copy to the device, which the host waits for, is a range of its
    own: ``aldi/sync/image_copy`` and ``aldi/sync/sizes_copy``
    (``utils/tracing.py``)."""
    if weights is not None:
        det.module.load_state_dict(weights)

    def fn(images, sizes):
        with sync("image_copy"):
            images = torch.as_tensor(images, dtype=torch.float32,
                                     device=det.device)
        with sync("sizes_copy"):
            sizes = torch.as_tensor(sizes, dtype=torch.int32,
                                    device=det.device)
        return dict(zip(_OUTPUTS, det.forward_inference(images, sizes)))

    return fn


class _Serving(nn.Module):
    """What is exported: ``forward(images, sizes)`` runs the detector's
    inference body (``RCNNDetector.detect`` or ``YoloDetector.detect``)
    under ``no_grad`` and returns (boxes, scores, classes, valid). The
    detector's weights (and YOLO's running statistics) are this module's
    parameters and buffers."""

    def __init__(self, det):
        super().__init__()
        self.model = det.module
        self.det = det

    def forward(self, images, sizes):
        with torch.no_grad():
            return tuple(self.det.detect(images, sizes))


def _on_platform(det, platform):
    """``det`` if it lives on ``platform``, else a copy built there from its
    config with its weights."""
    if det.device.type == platform:
        return det
    from ..models import build_detector

    copy = build_detector(det.cfg, device=platform)
    copy.module.load_state_dict(det.module.state_dict())
    return copy


def export_inference(det, weights, batch_size, platforms=None):
    """Export the inference path: ``{platform: ExportedProgram}``.

    ``weights``: a state dict loaded into ``det`` first, or None to keep
    its own. ``platforms`` defaults to ``("cpu", "cuda")`` on a host with a
    card and ``("cpu",)`` without one. Each platform's program is traced
    with the detector on that device (a copy where ``det`` lives
    elsewhere), as the JAX package traces each platform on its own.
    """
    if mesh.model_world() > 1:
        raise NotImplementedError(
            "export_inference traces one card's whole model: under "
            "TPU.MESH_MODEL > 1 export from the world-1 checkpoint "
            "(tools/export_model.py) instead")
    if weights is not None:
        det.module.load_state_dict(weights)
    if platforms is None:
        platforms = ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)
    h, w = det.canvas
    out = {}
    for platform in platforms:
        d = _on_platform(det, platform)
        images = torch.zeros((batch_size, h, w, 3), dtype=torch.float32,
                             device=d.device)
        sizes = torch.tensor([[h, w]] * batch_size, dtype=torch.int32,
                             device=d.device)
        program = torch.export.export(_Serving(d), (images, sizes),
                                      strict=False)
        # the zero request traced above would be saved with the program
        # (8 x 1024x2048 images: 201 MB)
        program.example_inputs = None
        out[platform] = program
    return out


def save_artifact(path, blobs, det, cfg, batch_size):
    """Write the per-platform programs + host-side metadata to ``path``."""
    os.makedirs(path, exist_ok=True)
    for platform, program in blobs.items():
        torch.export.save(program, os.path.join(path, _module_name(platform)))
    h, w = det.canvas
    # The exported graph bakes in the detector's preprocess (mean/std in the
    # configured channel order), so the serving host must feed pixels in
    # cfg.INPUT.FORMAT — BGR for the default/flagship Caffe-style configs.
    input_format = cfg.INPUT.FORMAT
    meta = {
        "format_version": _FORMAT_VERSION,
        "canvas": [int(h), int(w)],
        "batch_size": int(batch_size),
        "num_classes": int(det.num_classes),
        "meta_architecture": cfg.MODEL.META_ARCHITECTURE,
        "input_format": input_format,
        "platforms": sorted(blobs),
        "inputs": {
            "images": {"shape": [batch_size, h, w, 3], "dtype": "float32",
                       "note": f"0-255 {input_format}, padded bottom/right "
                               "to canvas"},
            "sizes": {"shape": [batch_size, 2], "dtype": "int32",
                      "note": "valid (h, w) per image before padding"},
        },
        "outputs": {
            "boxes": "xyxy on the canvas; rescale by original/canvas ratio",
            "scores": "post-sigmoid/softmax detection scores",
            "classes": "contiguous class ids",
            "valid": "detection mask (padded rows are False)",
        },
    }
    with open(os.path.join(path, _META_NAME), "w") as f:
        json.dump(meta, f, indent=1)


class ServingModel:
    """A loaded artifact: ``model(images, sizes) -> dict`` plus its meta.
    Inputs may be numpy arrays or tensors on any device; outputs are on the
    platform's device. ``module`` is the program's graph module
    (``ExportedProgram.module()``)."""

    def __init__(self, exported, meta, platform):
        self.meta = meta
        self.platform = platform
        self.device = torch.device(platform)
        self.module = exported.module()

    def __call__(self, images, sizes):
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        sizes = torch.as_tensor(sizes, dtype=torch.int32, device=self.device)
        with torch.no_grad():
            return dict(zip(_OUTPUTS, self.module(images, sizes)))


def load_artifact(path, platform=None):
    """Load an exported artifact directory for ``platform`` (default:
    ``cuda``, which raises without a card; pass ``platform="cpu"`` for the
    CPU program)."""
    with open(os.path.join(path, _META_NAME)) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta.get('format_version')} != "
            f"supported {_FORMAT_VERSION}"
        )
    platform = platform or "cuda"
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass platform='cpu' to "
                           "load the artifact's CPU program")
    if platform not in meta["platforms"]:
        raise ValueError(
            f"artifact has no module for platform {platform!r} "
            f"(available: {meta['platforms']})"
        )
    exported = torch.export.load(os.path.join(path, _module_name(platform)))
    return ServingModel(exported, meta, platform)
