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
CUDA kernel behind ``roi_align_kernel.roi_align_bwd``, which owns the
gradient tile by tile; ``roi_tile_terms`` and ``roi_align_tiled_backward``
replay that kernel's binning and sum in plain PyTorch (its CPU rehearsal).

``roi_align_batched`` calls the custom op ``aldi_tpu_torch::roi_align_fwd``
(``custom_ops.py``), whose dispatcher sends CPU tensors to the plain
versions and CUDA tensors to the kernels, and whose autograd pairs the
forward with the backward op; the gradient with respect to the boxes is
None (proposal boxes are constants of the ROI stage, as the JAX package's
``stop_gradient`` makes them). Sampling ratio 2 and output 7x7 are what the
box pooler uses.
"""

import math

import torch

from . import custom_ops


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
        # a copy even in float32: the levels must not share the table (an
        # op's outputs may not alias each other)
        out.append(table[:, start:start + h * w].reshape(b, h, w, c)
                   .to(feat_dtype, copy=True))
        start += h * w
    return out


TILE = (8, 8)  # the backward kernel's kTileH x kTileW, csrc/roi_align_bwd.cu
_EMPTY = 2 ** 31 - 1  # INT_MAX: the low edge of an empty rectangle


def _box_rects(low, high, oob):
    """Per box, the low and high pixel its in-range samples' corners can
    touch on one axis ([P, S] -> two [P]); (INT_MAX, -1) without any."""
    inside = ~oob
    return (torch.where(inside, low, _EMPTY).amin(1),
            torch.where(inside, high, -1).amax(1))


def roi_tile_terms(boxes, levels, feat_hws, strides, output_size=7,
                   sampling_ratio=2, tile=TILE):
    """The terms the backward kernel adds for ONE image, tile by tile, in
    the order it adds them: the plain twin of ``csrc/roi_align_bwd.cu``'s
    binning and accumulation.

    A box's rectangle is, per axis, the min of the low and the max of the
    high corner index over its samples inside the level (a degenerate
    box's lattice runs backwards); a box with no such sample on an axis, or
    an invalid one, meets no tile. The tile (level, ty, tx), of ``tile``
    pixels, lists the boxes of its level whose rectangle meets it, in box
    order. For each listed box, sample row iy, sample column ix and corner
    00, 01, 10, 11 whose pixel lies in the tile, one term.

    boxes [P, 4] f32, levels [P] int32. Yields, for every tile that lists a
    box, ``(level, ty, tx, listed boxes, terms)``, terms a dict of [T]
    tensors: box, iy, ix, corner, y and x (the pixel in the level) and the
    float32 corner weight.
    """
    th, tw = tile
    p = boxes.shape[0]
    s = output_size * sampling_ratio
    y_axis, x_axis, (_, valid, _, _) = _axis_samples(
        boxes, levels, feat_hws, strides, output_size, sampling_ratio)
    ys = [t.reshape(p, s) for t in y_axis]  # low, high, l, oob
    xs = [t.reshape(p, s) for t in x_axis]
    ry0, ry1 = _box_rects(ys[0], ys[1], ys[3])
    rx0, rx1 = _box_rects(xs[0], xs[1], xs[3])
    touched = valid & (ry1 >= 0) & (rx1 >= 0)
    for lvl, (h, w) in enumerate(feat_hws):
        for ty in range(-(-h // th)):
            for tx in range(-(-w // tw)):
                y0, x0 = ty * th, tx * tw
                y1, x1 = min(y0 + th, h), min(x0 + tw, w)
                listed = torch.nonzero(
                    touched & (levels == lvl) & (ry0 < y1) & (ry1 >= y0)
                    & (rx0 < x1) & (rx1 >= x0)).flatten()
                if listed.numel():
                    terms = [_tile_box_terms(int(n), ys, xs, (y0, y1),
                                             (x0, x1), sampling_ratio)
                             for n in listed]
                    yield lvl, ty, tx, listed, {
                        k: torch.cat([t[k] for t in terms])
                        for k in terms[0]}


def _tile_box_terms(n, ys, xs, y_span, x_span, sampling_ratio):
    """The terms of box ``n`` inside the tile spanning ``y_span`` x
    ``x_span`` (half-open), in the kernel's (bin y, bin x, sample y,
    sample x, corner) order."""
    def axis(t, span):
        low, high, frac, oob = (v[n] for v in t)
        inside = [~oob & (c >= span[0]) & (c < span[1]) for c in (low, high)]
        return (low, high), inside, (1.0 - frac, frac)

    (y_c, y_in, y_w), (x_c, x_in, x_w) = axis(ys, y_span), axis(xs, x_span)
    corners = ((0, 0), (0, 1), (1, 0), (1, 1))
    s = y_c[0].shape[0]
    sr = sampling_ratio
    out = s // sr

    def order(t):  # [S, S, 4] by (iy, ix) -> [oy, ox, sy, sx, 4]
        return t.reshape(out, sr, out, sr, 4).permute(0, 2, 1, 3, 4)

    mask = order(torch.stack([y_in[a][:, None] & x_in[b][None, :]
                              for a, b in corners], -1))
    oy, ox, sy, sx, corner = torch.nonzero(mask, as_tuple=True)
    iy, ix = oy * sr + sy, ox * sr + sx
    return {
        "box": torch.full_like(iy, n), "iy": iy, "ix": ix, "corner": corner,
        "y": order(torch.stack([y_c[a][:, None].expand(s, s)
                                for a, _ in corners], -1))[mask],
        "x": order(torch.stack([x_c[b][None, :].expand(s, s)
                                for _, b in corners], -1))[mask],
        "weight": order(torch.stack([y_w[a][:, None] * x_w[b][None, :]
                                     for a, b in corners], -1))[mask]}


def roi_align_tiled_backward(grad, boxes, levels, feat_shapes, feat_dtype,
                             strides, sampling_ratio=2, tile=TILE):
    """The backward kernel's tile-owned sum replayed in plain PyTorch: the
    same d(features) as ``roi_align_plain_backward``, built tile by tile
    from ``roi_tile_terms``. Each tile's float32 accumulator adds the terms
    g / (sr*sr) * weight one after the other in the kernel's order
    (``index_add_`` on the CPU adds in index order); tiles no box touches
    stay zero; each level is cast to ``feat_dtype`` once. For CPU tensors:
    the rehearsal of the kernel's arithmetic."""
    b, p, output_size, _, c = grad.shape
    sr = sampling_ratio
    th, tw = tile
    g_s = grad.to(torch.float32).reshape(b, p, output_size ** 2, c) / float(
        sr * sr)
    outs = [torch.zeros((b, h, w, c), dtype=torch.float32,
                        device=grad.device) for h, w in feat_shapes]
    for i in range(b):
        for lvl, ty, tx, _, t in roi_tile_terms(
                boxes[i], levels[i], feat_shapes, strides, output_size, sr,
                tile):
            h, w = feat_shapes[lvl]
            y0, x0 = ty * th, tx * tw
            hh, ww = min(th, h - y0), min(tw, w - x0)
            bins = (t["iy"] // sr) * output_size + t["ix"] // sr
            acc = torch.zeros((hh * ww, c), dtype=torch.float32,
                              device=grad.device)
            acc.index_add_(0, (t["y"] - y0) * ww + t["x"] - x0,
                           g_s[i, t["box"], bins] * t["weight"][:, None])
            outs[lvl][i, y0:y0 + hh, x0:x0 + ww] = acc.reshape(hh, ww, c)
    return [o.to(feat_dtype) for o in outs]


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
    return custom_ops.roi_align_fwd(list(features), boxes, levels,
                                    list(strides), output_size,
                                    sampling_ratio)
