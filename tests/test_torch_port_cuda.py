"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: there, skip the JAX-loading conftest with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.

Tolerances: the ROIAlign kernels against their plain versions, float32
1e-5 (the same arithmetic, summed in another order; the backward's atomics
add in another order on every run) and bfloat16 one bf16 ulp of the value
(2^-7 relative); the matcher kernels exactly (the same IoU rounding); the
tiny detector on the card against the CPU in float32 with TF32 off, 1e-3 on
box coordinates of up to 128 px and 1e-4 on scores, and the tiny training
step 1e-4 relative on losses and 1e-5 on parameters (convolutions sum in
another order on each device).
"""

import numpy as np
import pytest
import torch

from aldi_tpu_torch.ops.anchors import AnchorGenerator
from aldi_tpu_torch.ops.match_kernel import (
    low_quality_mask, low_quality_mask_plain, match_boxes, match_boxes_plain,
    match_iou, match_iou_plain)
from aldi_tpu_torch.ops.roi_align import (box_levels, roi_align_batched,
                                          roi_align_plain,
                                          roi_align_plain_backward)
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd, roi_align_fwd
from chip_smoke import tiny_reference_check, tiny_train_reference_check

STRIDES = [4, 8, 16, 32]
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _roi_inputs(seed, b=3, p=64, c=256, canvas=(96, 160)):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((b, -(-canvas[0] // s), -(-canvas[1] // s),
                                  c)).astype(np.float32) for s in STRIDES]
    side = np.exp(rng.uniform(np.log(16), np.log(900), (b, p)))
    aspect = np.exp(rng.uniform(-1, 1, (b, p)))
    cx = rng.uniform(-20, canvas[1] + 20, (b, p))
    cy = rng.uniform(-20, canvas[0] + 20, (b, p))
    w, h = side * aspect, side / aspect
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     -1).astype(np.float32)
    valid = rng.uniform(0, 1, (b, p)) > 0.15
    return feats, boxes, valid


@pytest.mark.parametrize("channels", [8, 256, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_matches_plain(card, dtype, channels):
    """Channel counts below, at and above one thread per channel."""
    feats, boxes, valid = _roi_inputs(10, c=channels)
    f = [torch.from_numpy(x).to(card, dtype) for x in feats]
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    before = roi_align_fwd.launches
    got = roi_align_fwd(f, bx, levels, STRIDES).float()
    want = roi_align_plain(f, bx, levels, STRIDES).float()
    torch.cuda.synchronize()
    assert roi_align_fwd.launches == before + 1
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert bool(((got - want).abs() <= want.abs() * 2.0 ** -7 + 1e-6)
                    .all())


def test_roi_align_kernel_other_output_size(card):
    """POOLER_RESOLUTION 14 (the config default) with sampling ratio 2."""
    feats, boxes, valid = _roi_inputs(11, c=64)
    f = [torch.from_numpy(x).to(card) for x in feats]
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    got = roi_align_fwd(f, bx, levels, STRIDES, output_size=14)
    want = roi_align_plain(f, bx, levels, STRIDES, output_size=14)
    torch.cuda.synchronize()
    assert got.shape == (3, 64, 14, 14, 64)
    assert (got - want).abs().max().item() <= 1e-5


def test_tiny_detector_on_card_matches_cpu(card):
    """chip_smoke's reference check: a tiny float32 detector on the card
    against the same one on the CPU, TF32 off; fails (SystemExit) on
    disagreement."""
    tiny_reference_check()


def _anchors(card, canvas=(256, 512)):
    strides = [4, 8, 16, 32, 64]
    gen = AnchorGenerator([[32], [64], [128], [256], [512]],
                          [[0.5, 1.0, 2.0]], strides)
    hws = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in strides]
    return torch.from_numpy(np.concatenate(gen(hws))).to(card)


def _gt(card, b, m, seed, canvas=(256, 512)):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(16, 200, (b, m, 2))
    xy = rng.uniform(0, 1, (b, m, 2)) * (np.array(canvas[::-1]) - wh)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.uniform(0, 1, (b, m)) > 0.3
    valid[0, 0] = True
    return (torch.from_numpy(boxes).to(card),
            torch.from_numpy(valid).to(card))


@pytest.mark.parametrize("m", [1, 100, 256])
def test_match_kernels_equal_plain(card, m):
    """K1a/K1b against their plain versions: exactly equal vals, idx, per-gt
    best, low-quality mask and labels, for 1 gt slot up to the cap."""
    anchors = _anchors(card)
    gt, valid = _gt(card, 3, m, seed=m)
    before = (match_iou.launches, low_quality_mask.launches)
    vals, idx, best = match_iou(anchors, gt, valid)
    lowq = low_quality_mask(anchors, gt, valid, best)
    w_vals, w_idx, w_best = match_iou_plain(anchors, gt, valid)
    w_lowq = low_quality_mask_plain(anchors, gt, valid, w_best)
    labels = match_boxes(anchors, gt, valid, [0.3, 0.7], [0, -1, 1], True)
    w_labels = match_boxes_plain(anchors, gt, valid, [0.3, 0.7], [0, -1, 1],
                                 True)
    torch.cuda.synchronize()
    assert (match_iou.launches, low_quality_mask.launches) == (
        before[0] + 2, before[1] + 2)
    for got, want in ((vals, w_vals), (idx, w_idx), (best, w_best),
                      (lowq, w_lowq), (labels[0], w_labels[0]),
                      (labels[1], w_labels[1])):
        assert torch.equal(got, want)
    assert lowq.any() and (labels[1] == 1).any()


def test_match_kernel_raises_above_its_cap(card):
    anchors = _anchors(card)
    gt, valid = _gt(card, 1, 257, seed=0)
    with pytest.raises(ValueError, match="gt slots"):
        match_iou(anchors, gt, valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_matches_plain(card, dtype):
    feats, boxes, valid = _roi_inputs(12, c=256)
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    grad = torch.randn((3, 64, 7, 7, 256), device=card).to(dtype)
    before = roi_align_bwd.launches
    got = roi_align_bwd(grad, bx, levels, shapes, dtype, STRIDES)
    want = roi_align_plain_backward(grad, bx, levels, shapes, dtype, STRIDES)
    torch.cuda.synchronize()
    assert roi_align_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            assert (g - w).abs().max().item() <= 1e-5 * max(
                1.0, w.abs().max().item())
        else:
            assert bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-6).all())


def test_roi_align_function_backward_goes_to_the_kernel(card):
    """On CUDA tensors, ``roi_align_batched``'s gradient comes from the
    backward kernel, and equals the plain backward."""
    feats, boxes, valid = _roi_inputs(13, c=64)
    f = [torch.from_numpy(x).to(card).requires_grad_(True) for x in feats]
    bx = torch.from_numpy(boxes).to(card)
    vd = torch.from_numpy(valid).to(card)
    grad = torch.randn((3, 64, 7, 7, 64), device=card)
    before = (roi_align_fwd.launches, roi_align_bwd.launches)
    roi_align_batched(f, bx, vd, STRIDES).backward(grad)
    torch.cuda.synchronize()
    assert (roi_align_fwd.launches, roi_align_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = roi_align_plain_backward(
        grad, bx, box_levels(bx, vd, STRIDES),
        [(x.shape[1], x.shape[2]) for x in feats], torch.float32, STRIDES)
    for t, w in zip(f, want):
        assert (t.grad - w).abs().max().item() <= 1e-5 * max(
            1.0, w.abs().max().item())


def test_tiny_train_step_on_card_matches_cpu(card):
    """chip_smoke's training reference check; fails (SystemExit) on
    disagreement."""
    tiny_train_reference_check()
