"""ROIAlign (V2/aligned) over a multi-level feature pyramid.

Port of ``aldi_tpu/ops/roi_align.py``. Two versions of one function:

- ``roi_align_plain``: plain PyTorch with the JAX package's corner-gather
  semantics (``aldi_tpu/ops/roi_align.py:61-121,245-261``). All levels of
  one image are flattened into one ``[sum(H_l*W_l), C]`` table and every
  bilinear corner is a row index into it. The CPU path, and the reference
  the CUDA kernel is held against.
- the CUDA kernel behind ``roi_align_kernel.roi_align_fwd``, which replaces
  the Pallas forward ``aldi_tpu/ops/pallas_roi_align.py:183``.

The backward with respect to the features has the same two versions:
``roi_align_plain_backward`` (index-add into a float32 level table, as the
JAX package's ``_fused_bwd``, ``aldi_tpu/ops/roi_align.py:342``) and the
CUDA kernel behind ``roi_align_kernel.roi_align_bwd``. ``RoIAlignFunction``
pairs each forward with its backward; the gradient with respect to the
boxes is None (proposal boxes are constants of the ROI stage, as the JAX
package's ``stop_gradient`` makes them).

``roi_align_batched`` sends CPU tensors to the plain versions and CUDA
tensors to the kernels. Sampling ratio 2 and output 7x7 are what the box
pooler uses.
"""

import math

import torch

from .roi_align_kernel import roi_align_bwd, roi_align_fwd


def assign_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                  canonical_size: float = 224.0,
                  canonical_level: int = 4) -> torch.Tensor:
    """FPN level per box ([..., 4] f32 -> [...] int32, 0-based), substrate
    heuristic. Computed once here, in float32, and handed to the kernel:
    recomputing log2/sqrt on the device could round a box across a level
    boundary and change its whole output."""
    area = ((boxes[..., 2] - boxes[..., 0])
            * (boxes[..., 3] - boxes[..., 1])).clamp(min=0)
    size = torch.tensor(canonical_size, device=boxes.device)  # true division
    lvl = torch.floor(
        canonical_level + torch.log2(torch.sqrt(area) / size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32) - min_level


def box_levels(boxes: torch.Tensor, box_valid: torch.Tensor,
               strides) -> torch.Tensor:
    """Per-box level index for the pooler ([B, P] int32); -1 marks an
    invalid box, whose output is all zeros."""
    lvl = assign_levels(boxes.float(), int(math.log2(strides[0])),
                        int(math.log2(strides[-1])))
    return torch.where(box_valid, lvl, torch.full_like(lvl, -1))


def _bilinear_params(coord, size):
    """Clamped bilinear corner indices + weights for 1-D continuous coords
    (``aldi_tpu/ops/roi_align.py:61``)."""
    oob = (coord < -1.0) | (coord > size)
    c = coord.clamp(min=0.0)
    low = torch.minimum(c.to(torch.int64), size - 1)
    at_edge = low >= size - 1
    low = torch.where(at_edge, size - 1, low)
    high = torch.where(at_edge, size - 1, low + 1)
    c = torch.where(at_edge, low.to(c.dtype), c)
    return low, high, c - low.to(c.dtype), oob


def sample_geometry(boxes, levels, feat_hws, strides, output_size=7,
                    sampling_ratio=2):
    """Sampling lattice of ONE image's boxes, no feature reads.

    boxes [P, 4] f32, levels [P] int32 (-1 = invalid). Returns
    (idx4, w4, ok): four corner row indices into the image's level table
    and their weights, each [P, out, sr, out, sr], and ``ok``, the samples
    that read features (inside the level, of a valid box). Weights of the
    other samples are 0; they still count in each bin's mean.
    """
    dev = boxes.device
    hs = torch.tensor([h for h, _ in feat_hws], device=dev)
    ws = torch.tensor([w for _, w in feat_hws], device=dev)
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)
    sizes = hs * ws
    offsets = torch.cumsum(sizes, 0) - sizes

    valid = levels >= 0
    lvl = levels.clamp(min=0).to(torch.int64)
    scale, h_l, w_l = scales[lvl], hs[lvl], ws[lvl]

    b = boxes.to(torch.float32)
    # aligned=True: half-pixel offset on the start coordinate
    x0 = b[:, 0] * scale - 0.5
    y0 = b[:, 1] * scale - 0.5
    x1 = b[:, 2] * scale - 0.5
    y1 = b[:, 3] * scale - 0.5
    # divide by a device tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and XLA's CPU) true division, and one ulp of a coordinate
    # of hundreds of pixels moves the bilinear weights by ~1e-5
    n_bins = torch.tensor(float(output_size), device=dev)
    bin_w = (x1 - x0) / n_bins
    bin_h = (y1 - y0) / n_bins

    bin_idx = torch.arange(output_size, dtype=torch.float32, device=dev)
    s_idx = (torch.arange(sampling_ratio, dtype=torch.float32, device=dev)
             + 0.5) / sampling_ratio
    frac = bin_idx[None, :, None] + s_idx[None, None, :]  # [1, out, sr]
    ys = y0[:, None, None] + frac * bin_h[:, None, None]  # [P, out, sr]
    xs = x0[:, None, None] + frac * bin_w[:, None, None]

    y_low, y_high, ly, y_oob = _bilinear_params(ys, h_l[:, None, None])
    x_low, x_high, lx, x_oob = _bilinear_params(xs, w_l[:, None, None])

    # lattice dims [P, oy, sy, ox, sx]
    def ydim(t):
        return t[:, :, :, None, None]

    def xdim(t):
        return t[:, None, None, :, :]

    ok = ~(ydim(y_oob) | xdim(x_oob)) & valid[:, None, None, None, None]
    base = ydim(offsets[lvl][:, None, None])
    row = ydim(w_l[:, None, None])
    idx4 = [base + ydim(yv) * row + xdim(xv)
            for yv in (y_low, y_high) for xv in (x_low, x_high)]
    hy, hx = 1.0 - ly, 1.0 - lx
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    w4 = [torch.where(ok, ydim(wy) * xdim(wx), zero)
          for wy in (hy, ly) for wx in (hx, lx)]
    return idx4, w4, ok


def roi_align_plain(features, boxes, levels, strides, output_size=7,
                    sampling_ratio=2):
    """Plain PyTorch multi-level ROIAlign forward.

    features: per-level [B, H_l, W_l, C]; boxes [B, P, 4]; levels [B, P]
    int32 from ``box_levels``. Returns [B, P, out, out, C] in the features'
    dtype; corners are gathered in that dtype and summed in float32.
    """
    feat_hws = [(int(f.shape[1]), int(f.shape[2])) for f in features]
    c = features[0].shape[-1]
    outs = []
    for i in range(boxes.shape[0]):  # one image at a time bounds memory
        table = torch.cat([f[i].reshape(-1, c) for f in features], dim=0)
        idx4, w4, _ = sample_geometry(boxes[i], levels[i], feat_hws, strides,
                                      output_size, sampling_ratio)
        acc = sum(
            table[idx.reshape(-1)].reshape(idx.shape + (c,)).float()
            * w[..., None]
            for idx, w in zip(idx4, w4))
        outs.append(acc.mean(dim=(2, 4)).to(features[0].dtype))
    return torch.stack(outs)


def roi_align_plain_backward(grad, boxes, levels, feat_shapes, feat_dtype,
                             strides, sampling_ratio=2):
    """Plain PyTorch d(features) of ``roi_align_plain`` for the cotangent
    grad [B, P, out, out, C]: per image, each sample that reads features
    adds g / (sr*sr) times its four corner weights into a float32 table of
    all levels (``index_add_``), which is then split per level and cast to
    ``feat_dtype``, as ``_fused_bwd`` does. feat_shapes: per-level
    (H_l, W_l). Returns per-level [B, H_l, W_l, C]."""
    b, _, output_size, _, c = grad.shape
    rows = sum(h * w for h, w in feat_shapes)
    sr = sampling_ratio
    tables = []
    for i in range(b):
        idx4, w4, _ = sample_geometry(boxes[i], levels[i], feat_shapes,
                                      strides, output_size, sr)
        g_s = (grad[i].to(torch.float32) / float(sr * sr))[
            :, :, None, :, None, :].expand(idx4[0].shape + (c,))
        table = torch.zeros((rows, c), dtype=torch.float32,
                            device=grad.device)
        for idx, w in zip(idx4, w4):
            table.index_add_(0, idx.reshape(-1),
                             (g_s * w[..., None]).reshape(-1, c))
        tables.append(table)
    table = torch.stack(tables)  # [B, rows, C]
    out, start = [], 0
    for h, w in feat_shapes:
        out.append(table[:, start:start + h * w].reshape(b, h, w, c)
                   .to(feat_dtype))
        start += h * w
    return out


class RoIAlignFunction(torch.autograd.Function):
    """Multi-level ROIAlign with its backward: ``roi_align_plain`` and
    ``roi_align_plain_backward`` for CPU tensors, the forward and backward
    kernels for CUDA tensors. The levels are computed once by the caller
    and saved for the backward; the boxes get no gradient."""

    @staticmethod
    def forward(ctx, boxes, levels, strides, output_size, sampling_ratio,
                *features):
        ctx.save_for_backward(boxes, levels)
        ctx.meta = (tuple(strides), sampling_ratio,
                    [(int(f.shape[1]), int(f.shape[2])) for f in features],
                    features[0].dtype)
        if boxes.device.type == "cpu":
            return roi_align_plain(features, boxes, levels, strides,
                                   output_size, sampling_ratio)
        return roi_align_fwd(features, boxes, levels, strides, output_size,
                             sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        boxes, levels = ctx.saved_tensors
        strides, sr, feat_shapes, dtype = ctx.meta
        grad = grad.contiguous()
        if boxes.device.type == "cpu":
            grads = roi_align_plain_backward(grad, boxes, levels,
                                             feat_shapes, dtype, strides, sr)
        else:
            grads = roi_align_bwd(grad, boxes, levels, feat_shapes, dtype,
                                  strides, sr)
        return (None, None, None, None, None, *grads)


def roi_align_batched(features, boxes, box_valid, strides, output_size=7,
                      sampling_ratio=2):
    """Batched multi-level ROIAlign: features per-level [B, H, W, C] (NHWC,
    contiguous), boxes [B, P, 4], box_valid [B, P] -> [B, P, out, out, C],
    differentiable in the features.

    CPU tensors take the plain versions; CUDA tensors launch the kernels or
    raise.
    """
    boxes = boxes.detach().to(torch.float32).contiguous()
    levels = box_levels(boxes, box_valid, strides)
    return RoIAlignFunction.apply(boxes, levels, list(strides), output_size,
                                  sampling_ratio, *features)
