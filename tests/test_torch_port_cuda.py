"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: there, skip the JAX-loading conftest with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.

Tolerances: the rel-pos attention kernels K3a/K3b as ``chip_smoke.check_attn``
states them; the ROIAlign kernels against their plain versions, float32
1e-5 (the same arithmetic, summed in another order: the plain backward's
index_add_ adds with atomics on the card, the kernel tile by tile) and
bfloat16 one bf16 ulp of the value
(2^-7 relative); the matcher kernels exactly (the same IoU rounding); the
tiny detector on the card against the CPU in float32 with TF32 off, 1e-3 on
box coordinates of up to 128 px and 1e-4 on scores, and the tiny training
step 1e-4 relative on losses and 1e-5 on parameters (convolutions sum in
another order on each device); the kernels' custom ops against their
wrappers' direct results exactly (the same launch), the assignment
solver K4 exactly equal to its plain version, and the tiny
detector's exported ``cuda`` program against the eager serving path
exactly, its ``cpu`` program with the tiny detector's tolerances.
"""

import numpy as np
import pytest
import torch

from aldi_tpu_torch.data.strong_aug import strong_aug_draws, strong_augment
from aldi_tpu_torch.ops import _build, custom_ops
from aldi_tpu_torch.ops.anchors import AnchorGenerator
from aldi_tpu_torch.ops.flash_attn import (attn_delta, flash_attention_relpos,
                                           flash_attn_plain)
from aldi_tpu_torch.ops.flash_attn_kernel import flash_attn_bwd, flash_attn_fwd
from aldi_tpu_torch.ops.lapjv import lapjv_plain
from aldi_tpu_torch.ops.lapjv_kernel import lapjv
from aldi_tpu_torch.ops.match_kernel import (
    low_quality_mask, low_quality_mask_plain, match_boxes, match_boxes_plain,
    match_iou, match_iou_plain)
from aldi_tpu_torch.ops.roi_align import (box_levels, roi_align_batched,
                                          roi_align_plain,
                                          roi_align_plain_backward)
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_bwd, roi_align_fwd
from chip_smoke import (ALIGN, CONVNEXT_ALDI, FLAGSHIP, VIT_ALDI,
                        attn_inputs, check_attn, tiny_artifact_check,
                        tiny_reference_check, tiny_train_reference_check,
                        tiny_vit, tied_lapjv_problems)
from torch_port_match_cases import CASES as MATCH_CASES
from torch_port_match_cases import match_case
from torch_port_threads import capped_torch_threads  # noqa: F401

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


def test_tiny_artifact_on_card_matches_eager(card):
    """chip_smoke's artifact check: the tiny detector's ``cuda`` program
    bitwise equal to the eager serving path on the card, its ``cpu``
    program within the reference tolerances; fails (SystemExit)
    otherwise."""
    tiny_artifact_check()


def _op_args(card, name):
    """Arguments of each kernel's custom op on the card, at small shapes the
    kernels take (head dim 64 for K3)."""
    anchors = _anchors(card)
    gt, valid = _gt(card, 2, 12, seed=51)
    if name in ("match_iou", "low_quality_mask"):
        best = match_iou_plain(anchors, gt, valid)[2]
        return (anchors, gt, valid) + ((best,) if name == "low_quality_mask"
                                       else ())
    if name.startswith("roi_align"):
        feats, boxes, valid = _roi_inputs(52, c=64)
        f = [torch.from_numpy(x).to(card, torch.bfloat16) for x in feats]
        bx = torch.from_numpy(boxes).to(card)
        levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
        if name == "roi_align_fwd":
            return f, bx, levels, STRIDES, 7, 2
        grad = torch.randn((3, 64, 7, 7, 64), device=card).to(torch.bfloat16)
        return (grad, bx, levels, [d for x in f for d in x.shape[1:3]],
                torch.bfloat16, STRIDES, 2)
    if name == "lapjv":
        return tied_lapjv_problems(torch.Generator(device=card).manual_seed(
            54), 6, 10, 30)
    q, k, v, bh, bw, dout = attn_inputs(torch.bfloat16, 53, 4, 16, 24)
    if name == "flash_attn_fwd":
        return q, k, v, bh, bw, 0.125, 16, 24
    out, lse = flash_attn_plain(q, k, v, bh, bw, 0.125, 16, 24)
    return (q, k, v, bh, bw, lse, attn_delta(out, dout), dout, 0.125, 16,
            24)


KERNEL_OPS = {"match_iou": match_iou, "low_quality_mask": low_quality_mask,
              "roi_align_fwd": roi_align_fwd, "roi_align_bwd": roi_align_bwd,
              "flash_attn_fwd": flash_attn_fwd,
              "flash_attn_bwd": flash_attn_bwd, "lapjv": lapjv}


@pytest.mark.parametrize("name", sorted(KERNEL_OPS))
def test_kernel_op_on_card_equals_its_wrapper(card, name):
    """Each custom op on CUDA tensors launches its kernel once and returns
    what the wrapper returns when called directly, bitwise (no kernel sums
    with atomics in an order that varies)."""
    wrapper = KERNEL_OPS[name]
    args = _op_args(card, name)
    if name == "roi_align_bwd":  # the wrapper takes the level shapes paired
        direct = (*args[:3], list(zip(args[3][::2], args[3][1::2])),
                  *args[4:])
    else:
        direct = args
    before = wrapper.launches
    got = getattr(custom_ops, name)(*args)
    assert wrapper.launches == before + 1
    want = wrapper(*direct)
    torch.cuda.synchronize()
    got, want = ([got], [want]) if torch.is_tensor(got) else (got, want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b), name


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


@pytest.mark.parametrize("shape", [(96, 100, 300), (24, 8, 20),
                                   (3, 60, 5000)])
def test_lapjv_kernel_equals_plain(card, shape):
    """K4 against ``lapjv_plain``, exactly (col4row and the settles), on
    problems with ties (duplicated rows, columns clipped to 1e4), with
    n_rows from 0 to n; the last shape's state lives in global scratch."""
    gen = torch.Generator(device=card).manual_seed(55)
    cost, n_rows = tied_lapjv_problems(gen, *shape)
    got = lapjv(cost, n_rows)
    want = lapjv_plain(cost, n_rows)
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a, b)
    random = torch.rand(shape, generator=gen, device=card)
    for a, b in zip(lapjv(random, n_rows), lapjv_plain(random, n_rows)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", MATCH_CASES)
def test_match_kernels_equal_plain(card, case):
    """K1a/K1b against their plain versions: exactly equal vals, idx, per-gt
    best, low-quality mask and labels, for 1 gt slot up to the cap and the
    adversarial gt of ``tests/torch_port_match_cases.py`` (touching edges,
    a box over the canvas, ties, zero-area and off-canvas boxes, an invalid
    first slot, an image without valid slots)."""
    anchors = _anchors(card)
    gt, valid = (torch.from_numpy(x).to(card)
                 for x in match_case(case, anchors.cpu().numpy()))
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


@pytest.mark.parametrize("erase,mic", [(True, False), (False, True)])
def test_strong_augment_on_card_returns_nhwc(card, erase, mic):
    """Each stream's strong view (the labeled stream's with erasing, the
    unlabeled stream's with MIC), blurred on half the images, returns
    NHWC-contiguous images on the card, so the backbone's convolutions read
    them channels-last."""
    gen = torch.Generator(device=card).manual_seed(4)
    img = torch.rand((4, 64, 96, 3), generator=gen, device=card) * 255.0
    draws = strong_aug_draws(gen, 4, (64, 96), erase, mic, 16)
    draws["do_blur"] = torch.tensor([True, False, True, False], device=card)
    sizes = torch.tensor([[64, 96], [50, 90], [64, 70], [40, 40]],
                         dtype=torch.int32, device=card)
    out = strong_augment(img, sizes, draws, erase, mic, 0.5)
    assert out.shape == img.shape and out.is_contiguous(), out.stride()


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


def _bwd_matches_plain(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        g, w = g.float(), w.float()
        if dtype == torch.float32:
            assert (g - w).abs().max().item() <= 1e-5 * max(
                1.0, w.abs().max().item())
        else:
            assert bool(((g - w).abs() <= w.abs() * 2.0 ** -7 + 1e-6).all())


def _bwd_case(card, dtype, boxes, levels, c, out=7, canvas=(96, 160),
              seed=0):
    """The backward kernel and the plain backward on these boxes and a
    seeded cotangent; returns (kernel's, plain's) per-level gradients."""
    shapes = [(-(-canvas[0] // s), -(-canvas[1] // s)) for s in STRIDES]
    b, p = levels.shape
    g = torch.Generator(device=card).manual_seed(seed)
    grad = torch.randn((b, p, out, out, c), generator=g, device=card).to(
        dtype)
    got = roi_align_bwd(grad, boxes, levels, shapes, dtype, STRIDES)
    want = roi_align_plain_backward(grad, boxes, levels, shapes, dtype,
                                    STRIDES)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("channels", [8, 64, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_channel_counts(card, dtype, channels):
    """Channel counts below one 16-byte vector per thread pair, and above
    one block's 256 channels (two channel chunks)."""
    feats, boxes, valid = _roi_inputs(14, c=channels)
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    _bwd_matches_plain(*_bwd_case(card, dtype, bx, levels, channels), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_other_output_size(card, dtype):
    """POOLER_RESOLUTION 14: a 28 x 28 sample lattice per box."""
    feats, boxes, valid = _roi_inputs(15, c=64)
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    _bwd_matches_plain(*_bwd_case(card, dtype, bx, levels, 64, out=14),
                       dtype)


def test_roi_align_bwd_kernel_boxes_straddle_tiles(card):
    """p2 boxes whose corners fall on both sides of the 8-pixel tile edges
    (every 32 px at stride 4), and boxes of odd sizes around them."""
    rng = np.random.default_rng(16)
    edge = rng.integers(1, 5, (2, 40)) * 32.0
    cy = rng.integers(1, 3, (2, 40)) * 32.0 + rng.uniform(-2, 2, (2, 40))
    half = rng.uniform(2, 30, (2, 40, 2))
    boxes = np.stack([edge - half[..., 0], cy - half[..., 1],
                      edge + half[..., 0], cy + half[..., 1]], -1)
    bx = torch.from_numpy(boxes.astype(np.float32)).to(card)
    levels = torch.zeros((2, 40), dtype=torch.int32, device=card)  # p2
    for dtype in (torch.float32, torch.bfloat16):
        _bwd_matches_plain(*_bwd_case(card, dtype, bx, levels, 256), dtype)


def test_roi_align_bwd_kernel_box_covers_a_level(card):
    """A p5 box larger than the canvas: its samples cover the whole level,
    every tile of it lists the box."""
    bx = torch.tensor([[[-40.0, -30.0, 200.0, 130.0],
                        [10.0, 10.0, 150.0, 90.0]]], device=card)
    levels = torch.full((1, 2), 3, dtype=torch.int32, device=card)
    got, want = _bwd_case(card, torch.float32, bx, levels, 64)
    _bwd_matches_plain(got, want, torch.float32)
    assert bool((got[3] != 0).all())


def test_roi_align_bwd_kernel_level_without_boxes_is_zero(card):
    """Levels that no box touches are written as zeros, although the
    wrapper allocates them with torch.empty: the allocator is first filled
    with NaN."""
    torch.full((64 << 20,), float("nan"), device=card)  # freed, cached
    feats, boxes, valid = _roi_inputs(17, c=256)
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    levels = torch.where(levels >= 0, torch.zeros_like(levels), levels)
    for dtype in (torch.float32, torch.bfloat16):
        got, want = _bwd_case(card, dtype, bx, levels, 256)
        _bwd_matches_plain(got, want, dtype)
        assert all(not g.any() for g in got[1:])
        assert bool(got[0].isfinite().all()) and got[0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_is_deterministic(card, dtype):
    """Two launches give bitwise equal gradients (no atomics)."""
    feats, boxes, valid = _roi_inputs(18, c=256)
    bx = torch.from_numpy(boxes).to(card)
    levels = box_levels(bx, torch.from_numpy(valid).to(card), STRIDES)
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    grad = torch.randn((3, 64, 7, 7, 256), device=card).to(dtype)
    first = roi_align_bwd(grad, bx, levels, shapes, dtype, STRIDES)
    second = roi_align_bwd(grad, bx, levels, shapes, dtype, STRIDES)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("grid,g", [((50, 84), 2), ((64, 128), 12),
                                    ((64, 64), 4), ((7, 5), 3),
                                    ((64, 128), 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_kernels_match_plain(card, dtype, grid, g):
    """K3a and K3b against ``flash_attn_plain``/``flash_attn_plain_backward``
    on ragged grids, at a 1024x1024 canvas's grid, at ViTDet-B's global
    blocks (N = 8192) and at one training-step launch (G = 48); fails
    (SystemExit) on disagreement."""
    before = (flash_attn_fwd.launches, flash_attn_bwd.launches)
    check_attn("card test", dtype, *grid, g, seed=31)
    assert (flash_attn_fwd.launches, flash_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attn_bwd_is_deterministic(card, dtype):
    """K3b has no atomics: two launches on the same inputs are bitwise
    equal."""
    q, k, v, bh, bw, dout = attn_inputs(dtype, 41, 12, 64, 128)
    out, lse = flash_attn_plain(q, k, v, bh, bw, 0.125, 64, 128)
    args = (q, k, v, bh, bw, lse, attn_delta(out, dout), dout, 0.125, 64,
            128)
    first = flash_attn_bwd(*args)
    second = flash_attn_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_attention_function_goes_to_the_kernels(card):
    """On CUDA tensors ``flash_attention_relpos`` and its gradient launch
    K3a and K3b once each."""
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        card).requires_grad_(True) for s in ((2, 35, 64), (2, 35, 64),
                                             (2, 35, 64), (2, 35, 7),
                                             (2, 35, 5))]
    before = (flash_attn_fwd.launches, flash_attn_bwd.launches)
    flash_attention_relpos(*args, 0.125, 7, 5).sum().backward()
    torch.cuda.synchronize()
    assert (flash_attn_fwd.launches, flash_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in args)


def test_cuda_tensors_without_a_kernel_raise(card, monkeypatch):
    """No fallback to the plain version: a library that cannot be built or
    loaded, or a head dim the kernel does not take, raises."""
    q = torch.zeros((1, 64, 64), device=card)
    b = torch.zeros((1, 64, 8), device=card)

    def no_library(name):
        raise RuntimeError(f"nvcc not found: {name} cannot be built")

    monkeypatch.setattr(_build, "load", no_library)
    with pytest.raises(RuntimeError, match="cannot be built"):
        flash_attention_relpos(q, q, q, b, b, 0.125, 8, 8)
    monkeypatch.undo()
    q32 = torch.zeros((1, 64, 32), device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_relpos(q32, q32, q32, b, b, 0.125, 8, 8)


def test_vitdet_detector_defaults_to_cuda(card):
    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.merge_from_file(VIT_ALDI)
    cfg.TPU.CANVAS = (128, 128)
    with tiny_vit():
        det = build_detector(cfg)
    assert det.device.type == "cuda"
    assert next(det.module.parameters()).device.type == "cuda"


def test_tiny_vitdet_on_card_matches_cpu(card):
    """chip_smoke's reference check for the tiny ViTDet (64-wide heads:
    the attention kernels run); fails (SystemExit) on disagreement."""
    with tiny_vit():
        tiny_reference_check(VIT_ALDI)


def test_tiny_vitdet_train_step_on_card_matches_cpu(card):
    with tiny_vit():
        tiny_train_reference_check(VIT_ALDI)


def test_tiny_convnext_on_card_matches_cpu(card):
    """chip_smoke's reference check for the tiny ConvNeXt; fails
    (SystemExit) on disagreement."""
    tiny_reference_check(CONVNEXT_ALDI)


def test_tiny_convnext_train_step_on_card_matches_cpu(card):
    tiny_train_reference_check(CONVNEXT_ALDI)


def test_tiny_aligned_train_step_on_card_matches_cpu(card):
    """The tiny flagship step with both discriminators and the target_weak
    stream, card against CPU."""
    tiny_train_reference_check(FLAGSHIP, ALIGN)


class _HostBatches:
    """A seekable host loader: batch i is a function of i (uint8 images,
    int32 sizes, nested as the trainer's batches are)."""

    def __init__(self):
        self.i = 0

    @staticmethod
    def batch(i):
        rng = np.random.default_rng(i)
        return {"labeled": {"image": rng.integers(0, 256, (4, 64, 96, 3),
                                                  dtype=np.uint8),
                            "sizes": rng.integers(1, 64, (4, 2),
                                                  dtype=np.int32)},
                "unlabeled": {"image": rng.integers(0, 256, (4, 64, 96, 3),
                                                    dtype=np.uint8)}}

    def seek(self, i):
        self.i = i

    def __next__(self):
        self.i += 1
        return self.batch(self.i - 1)


def _equal_on_card(got, want):
    for s, d in want.items():
        for k, v in d.items():
            t = got[s][k]
            assert t.is_cuda and t.dtype == torch.from_numpy(v).dtype
            # read on the consumer's stream, as a step would
            assert torch.equal(t.cpu(), torch.from_numpy(v)), (s, k)
            assert int((t.to(torch.int64) * 2).sum()) == 2 * int(v.sum())


def test_device_prefetcher_batches_equal_host(card):
    """Batches on the card equal the host's, after a pause of the consumer
    (the copy thread fills its queue) and after ``close()`` and a new
    prefetcher on the loader seeked to where the consumer stopped."""
    import time

    from aldi_tpu_torch.data.loader import DevicePrefetcher

    host = _HostBatches()
    pre = DevicePrefetcher(host, card, depth=2)
    for i in range(2):
        _equal_on_card(next(pre), _HostBatches.batch(i))
    time.sleep(0.5)  # the consumer pauses (an eval, a checkpoint)
    for i in range(2, 5):
        _equal_on_card(next(pre), _HostBatches.batch(i))
    pre.close()
    assert not pre._thread.is_alive()
    host.seek(5)
    pre = DevicePrefetcher(host, card, depth=3)
    for i in range(5, 8):
        _equal_on_card(next(pre), _HostBatches.batch(i))
    pre.close()


@pytest.mark.parametrize("accum", [1, 2])
def test_tiny_trainer_on_card_checkpoints_and_resumes(card, tmp_path, accum):
    """The trainer on the card at the tiny float32 config (and with
    TPU.GRAD_ACCUM 2): 2 iterations with a checkpoint at each, then a new
    trainer resumed from the second goes on at iteration 2 with its
    weights, teacher and momentum, to 3."""
    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.data.catalog import (DatasetCatalog,
                                             register_coco_instances)
    from aldi_tpu_torch.engine.trainer import ALDITrainer
    from chip_smoke import write_synthetic_coco

    names = {}
    for split, n, seed in (("train", 6, 1), ("unlabeled", 6, 2),
                           ("val", 4, 3)):
        names[split] = f"card_tiny_{split}"
        if names[split] not in DatasetCatalog:
            register_coco_instances(names[split], {}, *write_synthetic_coco(
                str(tmp_path), names[split], n, seed, num_classes=3,
                size=(96, 128), box_px=(12, 48)))

    def cfg_for(max_iter):
        cfg = get_cfg()
        cfg.merge_from_file(FLAGSHIP)
        cfg.merge_from_list([
            "MODEL.DEVICE", "cuda", "MODEL.WEIGHTS", "",
            "MODEL.RESNETS.DEPTH", "26", "MODEL.ROI_HEADS.NUM_CLASSES", "3",
            "TPU.CANVAS", "(128, 128)", "TPU.MAX_GT", "8",
            "TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TRAIN",
            "(96, 112)", "INPUT.MAX_SIZE_TRAIN", "128",
            "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128",
            "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
            "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
            "DATASETS.TRAIN", f"('{names['train']}',)",
            "DATASETS.UNLABELED", f"('{names['unlabeled']}',)",
            "DATASETS.TEST", f"('{names['val']}',)",
            "SOLVER.IMS_PER_BATCH", "4", "SOLVER.MAX_ITER", str(max_iter),
            "SOLVER.CHECKPOINT_PERIOD", "1", "TEST.EVAL_PERIOD", "0",
            "SOLVER.WARMUP_ITERS", "0", "SOLVER.BASE_LR", "0.01",
            "DOMAIN_ADAPT.TEACHER.THRESHOLD", "0.3",
            "OUTPUT_DIR", str(tmp_path / "out"), "SEED", "3",
            "TPU.GRAD_ACCUM", str(accum)])
        return cfg

    first = ALDITrainer(cfg_for(2))
    assert first.device.type == "cuda"
    first.train()
    assert {"model_0000001.pth", "model_0000002.pth"} <= set(
        p.name for p in (tmp_path / "out").iterdir())
    resumed = ALDITrainer(cfg_for(3))
    resumed.resume_or_load(resume=True)
    assert resumed.state.step == 2
    for a, b in ((first.state.student, resumed.state.student),
                 (first.state.teacher, resumed.state.teacher)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    ma, mb = (t.state.optimizer.state_dict()["state"] for t in
              (first, resumed))
    assert ma.keys() == mb.keys() and len(ma) > 0
    assert all(torch.equal(ma[i]["momentum_buffer"], mb[i]["momentum_buffer"])
               for i in ma)
    results = resumed.train()
    assert results == {} and resumed.state.step == 3
    assert (tmp_path / "out" / "model_0000003.pth").exists()
    assert resumed.test()[names["val"]]["bbox/AP50"] >= 0
