"""ROIAlign (V2/aligned) over a multi-level feature pyramid, in plain
PyTorch with the JAX package's corner-gather semantics: all levels of one
image flattened into one ``[sum(H_l*W_l), C]`` table, every bilinear corner a
row index into it. Its gradient with respect to the features comes from
autograd. Sampling ratio 2 and output 7x7 are what the box pooler uses."""

import math

import torch



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


def _axis_samples(boxes, levels, feat_hws, strides, output_size,
                  sampling_ratio):
    """Per axis, the samples of ONE image's boxes (boxes [P, 4] f32, levels
    [P] int32, -1 = invalid): ``(low, high, l, oob)`` for y and for x, each
    [P, out, sr], with the level of each box as (lvl, valid, level row
    offset, level width)."""
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
    return (_bilinear_params(ys, h_l[:, None, None]),
            _bilinear_params(xs, w_l[:, None, None]),
            (lvl, valid, offsets[lvl], w_l))


def sample_geometry(boxes, levels, feat_hws, strides, output_size=7,
                    sampling_ratio=2):
    """Sampling lattice of ONE image's boxes, no feature reads.

    boxes [P, 4] f32, levels [P] int32 (-1 = invalid). Returns
    (idx4, w4, ok): four corner row indices into the image's level table
    and their weights, each [P, out, sr, out, sr], and ``ok``, the samples
    that read features (inside the level, of a valid box). Weights of the
    other samples are 0; they still count in each bin's mean.
    """
    ((y_low, y_high, ly, y_oob), (x_low, x_high, lx, x_oob),
     (lvl, valid, offset, w_l)) = _axis_samples(
        boxes, levels, feat_hws, strides, output_size, sampling_ratio)

    # lattice dims [P, oy, sy, ox, sx]
    def ydim(t):
        return t[:, :, :, None, None]

    def xdim(t):
        return t[:, None, None, :, :]

    ok = ~(ydim(y_oob) | xdim(x_oob)) & valid[:, None, None, None, None]
    base = ydim(offset[:, None, None])
    row = ydim(w_l[:, None, None])
    idx4 = [base + ydim(yv) * row + xdim(xv)
            for yv in (y_low, y_high) for xv in (x_low, x_high)]
    hy, hx = 1.0 - ly, 1.0 - lx
    zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
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


def roi_align_batched(features, boxes, box_valid, strides, output_size=7,
                      sampling_ratio=2):
    """Batched multi-level ROIAlign: features per-level [B, H, W, C] (NHWC,
    contiguous), boxes [B, P, 4], box_valid [B, P] -> [B, P, out, out, C],
    differentiable in the features.

    """
    boxes = boxes.detach().to(torch.float32).contiguous()
    levels = box_levels(boxes, box_valid, strides)
    return roi_align_plain(list(features), boxes, levels, list(strides),
                           output_size, sampling_ratio)
