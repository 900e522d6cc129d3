"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: there, skip the JAX-loading conftest with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py``.

Tolerances: the kernel against its plain version, float32 1e-5 (the same
arithmetic, summed in another order) and bfloat16 one bf16 ulp of the value
(2^-7 relative); the tiny detector on the card against the CPU in float32
with TF32 off, 1e-3 on box coordinates of up to 128 px and 1e-4 on scores
(convolutions sum in another order on each device).
"""

import numpy as np
import pytest
import torch

from aldi_tpu_torch.ops.roi_align import box_levels, roi_align_plain
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd
from chip_smoke import tiny_reference_check

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
