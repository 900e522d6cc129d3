"""The tile-owned ROIAlign backward (K2 backward), on the CPU.

The CUDA kernel ``csrc/roi_align_bwd.cu`` owns the gradient tile by tile:
each block lists the boxes whose pixel rectangle meets its tile and adds
their terms in a fixed order into a float32 accumulator, then writes the
tile once. ``roi_tile_terms`` and ``roi_align_tiled_backward`` replay that
binning and sum in plain PyTorch; these tests hold them against the plain
backward ``roi_align_plain_backward`` (the reference the kernel is held
against on the card): every in-range (sample, corner) term of every valid
box is added in exactly one tile, and the tile-owned sum equals the plain
one (float32 within 1e-6 of the scale: the same terms summed in another
order; bfloat16 within one bf16 ulp of each value: one rounding of each
float32 sum), for ordinary, degenerate and out-of-range boxes, a level no
box touches, other tile sizes and output size 14.
"""

import numpy as np
import pytest
import torch

from aldi_tpu_torch.ops.roi_align import (TILE, box_levels, roi_align_plain_backward,
                                          roi_align_tiled_backward,
                                          roi_tile_terms, sample_geometry)

STRIDES = [4, 8, 16, 32]
CANVAS = (64, 96)  # levels 16x24, 8x12, 4x6, 2x3
SHAPES = [(-(-CANVAS[0] // s), -(-CANVAS[1] // s)) for s in STRIDES]
CASES = ("mixed", "degenerate", "beyond_edges", "one_level")


def _boxes(case, seed, b=2, p=10):
    """[b, p, 4] float32 boxes and [b, p] valid flags for ``case``."""
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    if case == "degenerate":  # zero-size and reversed boxes
        x0 = rng.uniform(-8, w + 8, (b, p))
        y0 = rng.uniform(-8, h + 8, (b, p))
        dx = rng.choice([0.0, -1.0, 1.0], (b, p)) * rng.uniform(0, 60, (b, p))
        dy = rng.choice([0.0, -1.0, 1.0], (b, p)) * rng.uniform(0, 60, (b, p))
        boxes = np.stack([x0, y0, x0 + dx, y0 + dy], -1)
    elif case == "beyond_edges":  # across or beyond each edge and corner
        cx = rng.choice([-30.0, -5.0, w + 5.0, w + 30.0, w / 2], (b, p))
        cy = rng.choice([-30.0, -5.0, h + 5.0, h + 30.0, h / 2], (b, p))
        side = rng.uniform(4, 120, (b, p, 2))
        boxes = np.stack([cx - side[..., 0], cy - side[..., 1],
                          cx + side[..., 0], cy + side[..., 1]], -1)
    else:
        lo, hi = (4, 40) if case == "one_level" else (6, 400)
        side = np.exp(rng.uniform(np.log(lo), np.log(hi), (b, p)))
        aspect = np.exp(rng.uniform(-1, 1, (b, p)))
        cx, cy = rng.uniform(-10, w + 10, (b, p)), rng.uniform(-10, h + 10,
                                                               (b, p))
        bw, bh = side * aspect, side / aspect
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                         -1)
    valid = rng.uniform(0, 1, (b, p)) > 0.15
    boxes = torch.from_numpy(boxes.astype(np.float32))
    valid = torch.from_numpy(valid)
    levels = box_levels(boxes, valid, STRIDES)
    if case == "one_level":
        levels = torch.where(valid, torch.zeros_like(levels), levels)
    return boxes, levels


@pytest.mark.parametrize("output_size", [7, 14])
@pytest.mark.parametrize("case", CASES)
def test_every_term_lands_in_exactly_one_tile(case, output_size):
    """The terms of all tiles are exactly the in-range (sample, corner)
    terms of the plain version's lattice, each once, at its pixel and with
    its weight; each tile lists boxes of its level in box order."""
    boxes, levels = _boxes(case, seed=CASES.index(case) + output_size)
    sizes = torch.tensor([h * w for h, w in SHAPES])
    offsets = torch.cumsum(sizes, 0) - sizes
    s = output_size * 2
    n_terms = 0
    for i in range(boxes.shape[0]):
        idx4, w4, ok = sample_geometry(boxes[i], levels[i], SHAPES, STRIDES,
                                       output_size)
        p = boxes.shape[1]
        ok = ok.reshape(p, s, s)
        want = {}
        for k in range(4):
            for n, iy, ix in torch.nonzero(ok).tolist():
                want[(n, iy, ix, k)] = (
                    int(idx4[k].reshape(p, s, s)[n, iy, ix]),
                    float(w4[k].reshape(p, s, s)[n, iy, ix]))
        got = {}
        for lvl, ty, tx, listed, t in roi_tile_terms(
                boxes[i], levels[i], SHAPES, STRIDES, output_size):
            assert torch.equal(listed, torch.sort(listed).values)
            assert bool((levels[i][listed] == lvl).all())
            w = SHAPES[lvl][1]
            assert bool(((t["y"] // TILE[0] == ty)
                         & (t["x"] // TILE[1] == tx)).all())
            for n, iy, ix, k, y, x, wt in zip(
                    *(t[key].tolist() for key in (
                        "box", "iy", "ix", "corner", "y", "x", "weight"))):
                key = (n, iy, ix, k)
                assert key not in got, f"term {key} added twice"
                got[key] = (int(offsets[lvl]) + y * w + x, wt)
        assert got == want
        n_terms += len(got)
    assert n_terms > 0


def _check(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            assert (g - w).abs().max().item() <= 1e-6 * max(
                1.0, w.abs().max().item())
        else:
            assert bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-6).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_tiled_backward_matches_plain(case, dtype):
    boxes, levels = _boxes(case, seed=10 + CASES.index(case))
    b, p = levels.shape
    rng = np.random.default_rng(20)
    grad = torch.from_numpy(rng.standard_normal((b, p, 7, 7, 8)).astype(
        np.float32)).to(dtype)
    got = roi_align_tiled_backward(grad, boxes, levels, SHAPES, dtype,
                                   STRIDES)
    want = roi_align_plain_backward(grad, boxes, levels, SHAPES, dtype,
                                    STRIDES)
    _check(got, want, dtype)
    if case == "one_level":  # levels p3..p5 hold no box: all zeros
        assert all(not g.any() for g in got[1:])
        assert got[0].any()


@pytest.mark.parametrize("tile", [(8, 8), (4, 8), (3, 5)])
def test_tiled_backward_other_tiles_and_output_size(tile):
    """Tiles that do not divide the levels, and output size 14."""
    boxes, levels = _boxes("mixed", seed=30)
    b, p = levels.shape
    rng = np.random.default_rng(31)
    grad = torch.from_numpy(rng.standard_normal((b, p, 14, 14, 4)).astype(
        np.float32))
    got = roi_align_tiled_backward(grad, boxes, levels, SHAPES,
                                   torch.float32, STRIDES, tile=tile)
    want = roi_align_plain_backward(grad, boxes, levels, SHAPES,
                                    torch.float32, STRIDES)
    _check(got, want, torch.float32)
