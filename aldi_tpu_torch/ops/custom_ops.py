"""The port's kernels as ``torch.library`` custom ops, namespace
``aldi_tpu_torch``.

Each op has two implementations, chosen by PyTorch's dispatcher from the
device of its tensors: ``cpu`` is the kernel's plain PyTorch version and
``cuda`` its wrapper, which launches the kernel (counting the launch) or
raises; no op falls back from one to the other. Each has a fake
implementation that gives its outputs' shapes and dtypes, so
``torch.export`` keeps the op as one call node in the graph instead of
tracing into it (the ctypes launch cannot run on fake tensors), and a
loaded artifact dispatches to the kernel on the card. ROIAlign's forward and
the rel-pos attention's forward get their backward through
``register_autograd``, from the backward op. Each op, its plain version
(cpu) and its kernel (cuda):

- ``match_iou`` (K1a): ``match_kernel.match_iou_plain`` /
  ``csrc/match_iou.cu``
- ``low_quality_mask`` (K1b): ``match_kernel.low_quality_mask_plain`` /
  ``csrc/match_iou.cu``
- ``roi_align_fwd`` (K2): ``roi_align.roi_align_plain`` /
  ``csrc/roi_align_fwd.cu``
- ``roi_align_bwd`` (K2): ``roi_align.roi_align_plain_backward`` /
  ``csrc/roi_align_bwd.cu``
- ``flash_attn_fwd`` (K3a): ``flash_attn.flash_attn_plain`` /
  ``csrc/flash_attn_fwd.cu``
- ``flash_attn_bwd`` (K3b): ``flash_attn.flash_attn_plain_backward`` /
  ``csrc/flash_attn_bwd.cu``
- ``lapjv`` (K4, the DETR criterion's assignment solver; no gradient):
  ``lapjv.lapjv_plain`` / ``csrc/lapjv.cu``
- ``conv_epilogue`` (a conv's bias, residual or top-down add and ReLU, in
  place on the conv's output; a port-only kernel):
  ``conv_epilogue.conv_epilogue_plain`` / ``csrc/conv_epilogue.cu``
- ``conv_epilogue_bwd``: ``conv_epilogue.conv_epilogue_plain_backward`` /
  ``csrc/conv_epilogue.cu``

The two epilogue ops are defined on a ``torch.library.Library`` with their
schemas rather than through ``custom_op``, whose Python wrapper costs
tens of microseconds a call on the host: an R50-FPN request calls the
forward 72 times. Its gradient is ``conv_epilogue.ConvEpilogueFunction``.

``roi_align_bwd`` takes the level shapes flattened (``[H_0, W_0, H_1,
...]``). Importing this module registers the ops; the kernels are built at
their first launch, never on import.
"""

from typing import List, Tuple

import torch
from torch import Tensor

from . import conv_epilogue as epilogue
from . import conv_epilogue_kernel, flash_attn, flash_attn_kernel
from . import lapjv_kernel, match_kernel, roi_align, roi_align_kernel
from .lapjv import lapjv_plain

_NS = "aldi_tpu_torch"


def _pairs(flat):
    return [(int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2)]


# ------------------------------------------------------- K1a, K1b: matcher
@torch.library.custom_op(f"{_NS}::match_iou", mutates_args=(),
                         device_types="cpu")
def match_iou(anchors: Tensor, gt_boxes: Tensor,
              gt_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """anchors [N, 4], gt_boxes [B, M, 4], gt_valid [B, M] -> (vals [B, N]
    f32, idx [B, N] int32, best [B, M] f32)."""
    return match_kernel.match_iou_plain(anchors, gt_boxes, gt_valid)


@match_iou.register_kernel("cuda")
def _(anchors, gt_boxes, gt_valid):
    return match_kernel.match_iou(anchors, gt_boxes, gt_valid)


@match_iou.register_fake
def _(anchors, gt_boxes, gt_valid):
    b, n = gt_valid.shape[0], anchors.shape[0]
    return (anchors.new_empty((b, n)),
            anchors.new_empty((b, n), dtype=torch.int32),
            anchors.new_empty(gt_valid.shape))


@torch.library.custom_op(f"{_NS}::low_quality_mask", mutates_args=(),
                         device_types="cpu")
def low_quality_mask(anchors: Tensor, gt_boxes: Tensor, gt_valid: Tensor,
                     best: Tensor) -> Tensor:
    """As ``match_iou`` plus its best [B, M] -> bool [B, N]."""
    return match_kernel.low_quality_mask_plain(anchors, gt_boxes, gt_valid,
                                               best)


@low_quality_mask.register_kernel("cuda")
def _(anchors, gt_boxes, gt_valid, best):
    return match_kernel.low_quality_mask(anchors, gt_boxes, gt_valid, best)


@low_quality_mask.register_fake
def _(anchors, gt_boxes, gt_valid, best):
    return anchors.new_empty((gt_valid.shape[0], anchors.shape[0]),
                             dtype=torch.bool)


# ---------------------------------------------------------- K2: ROIAlign
@torch.library.custom_op(f"{_NS}::roi_align_fwd", mutates_args=(),
                         device_types="cpu")
def roi_align_fwd(features: List[Tensor], boxes: Tensor, levels: Tensor,
                  strides: List[int], output_size: int,
                  sampling_ratio: int) -> Tensor:
    """features per-level [B, H_l, W_l, C], boxes [B, P, 4] f32, levels
    [B, P] int32 (-1 = invalid) -> [B, P, out, out, C] in the features'
    dtype."""
    return roi_align.roi_align_plain(features, boxes, levels, strides,
                                     output_size, sampling_ratio)


@roi_align_fwd.register_kernel("cuda")
def _(features, boxes, levels, strides, output_size, sampling_ratio):
    return roi_align_kernel.roi_align_fwd(features, boxes, levels, strides,
                                          output_size, sampling_ratio)


@roi_align_fwd.register_fake
def _(features, boxes, levels, strides, output_size, sampling_ratio):
    b, p = boxes.shape[:2]
    return features[0].new_empty(
        (b, p, output_size, output_size, features[0].shape[-1]))


@torch.library.custom_op(f"{_NS}::roi_align_bwd", mutates_args=(),
                         device_types="cpu")
def roi_align_bwd(grad: Tensor, boxes: Tensor, levels: Tensor,
                  feat_shapes: List[int], feat_dtype: torch.dtype,
                  strides: List[int], sampling_ratio: int) -> List[Tensor]:
    """d(features) of ``roi_align_fwd`` for grad [B, P, out, out, C]:
    per-level [B, H_l, W_l, C] in ``feat_dtype``; ``feat_shapes`` the
    flattened per-level (H_l, W_l)."""
    return roi_align.roi_align_plain_backward(
        grad, boxes, levels, _pairs(feat_shapes), feat_dtype, strides,
        sampling_ratio)


@roi_align_bwd.register_kernel("cuda")
def _(grad, boxes, levels, feat_shapes, feat_dtype, strides, sampling_ratio):
    return roi_align_kernel.roi_align_bwd(
        grad, boxes, levels, _pairs(feat_shapes), feat_dtype, strides,
        sampling_ratio)


@roi_align_bwd.register_fake
def _(grad, boxes, levels, feat_shapes, feat_dtype, strides, sampling_ratio):
    b, c = grad.shape[0], grad.shape[-1]
    return [grad.new_empty((b, h, w, c), dtype=feat_dtype)
            for h, w in _pairs(feat_shapes)]


def _roi_align_setup(ctx, inputs, output):
    features, boxes, levels, strides, _, sampling_ratio = inputs
    ctx.save_for_backward(boxes, levels)
    ctx.meta = ([d for f in features for d in f.shape[1:3]],
                features[0].dtype, list(strides), sampling_ratio)


def _roi_align_backward(ctx, grad):
    boxes, levels = ctx.saved_tensors
    feat_shapes, dtype, strides, sampling_ratio = ctx.meta
    grads = roi_align_bwd(grad.contiguous(), boxes, levels, feat_shapes,
                          dtype, strides, sampling_ratio)
    return list(grads), None, None, None, None, None


roi_align_fwd.register_autograd(_roi_align_backward,
                                setup_context=_roi_align_setup)


# ------------------------------------------------ K3a, K3b: rel-pos attention
@torch.library.custom_op(f"{_NS}::flash_attn_fwd", mutates_args=(),
                         device_types="cpu")
def flash_attn_fwd(q: Tensor, k: Tensor, v: Tensor, bh: Tensor, bw: Tensor,
                   scale: float, h_grid: int,
                   w_grid: int) -> Tuple[Tensor, Tensor]:
    """q, k, v [G, N, D], bh [G, N, h] and bw [G, N, w] float32 -> (out
    [G, N, D] in q's dtype, lse [G, N] float32)."""
    return flash_attn.flash_attn_plain(q, k, v, bh, bw, scale, h_grid,
                                       w_grid)


@flash_attn_fwd.register_kernel("cuda")
def _(q, k, v, bh, bw, scale, h_grid, w_grid):
    return flash_attn_kernel.flash_attn_fwd(q, k, v, bh, bw, scale, h_grid,
                                            w_grid)


@flash_attn_fwd.register_fake
def _(q, k, v, bh, bw, scale, h_grid, w_grid):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


@torch.library.custom_op(f"{_NS}::flash_attn_bwd", mutates_args=(),
                         device_types="cpu")
def flash_attn_bwd(q: Tensor, k: Tensor, v: Tensor, bh: Tensor, bw: Tensor,
                   lse: Tensor, delta: Tensor, dout: Tensor, scale: float,
                   h_grid: int, w_grid: int
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of ``flash_attn_fwd`` for dout, from its lse and delta
    = rowsum(dout * out): (dq, dk, dv) in q's dtype, (dbh, dbw) float32."""
    return flash_attn.flash_attn_plain_backward(
        q, k, v, bh, bw, lse, delta, dout, scale, h_grid, w_grid)


@flash_attn_bwd.register_kernel("cuda")
def _(q, k, v, bh, bw, lse, delta, dout, scale, h_grid, w_grid):
    return flash_attn_kernel.flash_attn_bwd(
        q, k, v, bh, bw, lse, delta, dout, scale, h_grid, w_grid)


@flash_attn_bwd.register_fake
def _(q, k, v, bh, bw, lse, delta, dout, scale, h_grid, w_grid):
    g, n = q.shape[:2]
    return (torch.empty_like(q), torch.empty_like(q), torch.empty_like(q),
            q.new_empty((g, n, h_grid), dtype=torch.float32),
            q.new_empty((g, n, w_grid), dtype=torch.float32))


def _attn_setup(ctx, inputs, output):
    q, k, v, bh, bw, scale, h_grid, w_grid = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, bh, bw, out, lse)
    ctx.meta = (scale, h_grid, w_grid)


def _attn_backward(ctx, dout, _):
    q, k, v, bh, bw, out, lse = ctx.saved_tensors
    dout = dout.contiguous()
    grads = flash_attn_bwd(q, k, v, bh, bw, lse,
                           flash_attn.attn_delta(out, dout), dout, *ctx.meta)
    return (*grads, None, None, None)


flash_attn_fwd.register_autograd(_attn_backward, setup_context=_attn_setup)


# ------------------------------------------------- K4: assignment solver
@torch.library.custom_op(f"{_NS}::lapjv", mutates_args=(),
                         device_types="cpu")
def lapjv(cost: Tensor, n_rows: Tensor) -> Tuple[Tensor, Tensor]:
    """cost [P, n, m] f32, n_rows [P] int32 -> (col4row [P, n] int32,
    settles [P] int32)."""
    return lapjv_plain(cost, n_rows)


@lapjv.register_kernel("cuda")
def _(cost, n_rows):
    return lapjv_kernel.lapjv(cost, n_rows)


@lapjv.register_fake
def _(cost, n_rows):
    return (cost.new_empty(cost.shape[:2], dtype=torch.int32),
            cost.new_empty(cost.shape[:1], dtype=torch.int32))


# --------------------------------------- conv epilogue (port-only kernel)
_LIB = torch.library.Library(_NS, "FRAGMENT")
_LIB.define("conv_epilogue(Tensor(a!) y, Tensor bias, Tensor? residual, "
            "Tensor? coarse, bool relu) -> ()")
_LIB.define("conv_epilogue_bwd(Tensor grad, Tensor? out, bool bias_grad, "
            "bool coarse_grad) -> (Tensor, Tensor, Tensor)")


def _conv_epilogue_cpu(y, bias, residual, coarse, relu):
    y.copy_(epilogue.conv_epilogue_plain(y, bias, residual, coarse, relu))


def _conv_epilogue_bwd_cpu(grad, out, bias_grad, coarse_grad):
    return epilogue.conv_epilogue_plain_backward(grad, out, bias_grad,
                                                 coarse_grad)


_LIB.impl("conv_epilogue", _conv_epilogue_cpu, "CPU")
_LIB.impl("conv_epilogue", conv_epilogue_kernel.conv_epilogue, "CUDA")
_LIB.impl("conv_epilogue_bwd", _conv_epilogue_bwd_cpu, "CPU")
_LIB.impl("conv_epilogue_bwd", conv_epilogue_kernel.conv_epilogue_bwd,
          "CUDA")


@torch.library.register_fake(f"{_NS}::conv_epilogue", lib=_LIB)
def _(y, bias, residual, coarse, relu):
    return None


@torch.library.register_fake(f"{_NS}::conv_epilogue_bwd", lib=_LIB)
def _(grad, out, bias_grad, coarse_grad):
    n, c, h, w = grad.shape
    cl = torch.channels_last
    return (grad.new_empty(0) if out is None else torch.empty_like(grad),
            grad.new_empty(c if bias_grad else 0, dtype=torch.float32),
            grad.new_empty((n, c, h // 2, w // 2)).contiguous(
                memory_format=cl) if coarse_grad else grad.new_empty(0))


# in place on y [N, C, H, W]: y + bias [C] float32 (+ residual, y's shape)
# (+ the nearest-2x upsampling of coarse [N, C, H/2, W/2]), ReLU if relu
conv_epilogue = torch.ops.aldi_tpu_torch.conv_epilogue.default
# (grad zeroed where out <= 0, or empty without out; the float32 bias
# gradient, or empty; the coarse map's gradient, or empty)
conv_epilogue_bwd = torch.ops.aldi_tpu_torch.conv_epilogue_bwd.default
