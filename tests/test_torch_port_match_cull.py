"""The culled anchor matcher (K1a/K1b), on the CPU.

The CUDA kernels ``csrc/match_iou.cu`` cut the anchors into blocks of
consecutive anchors, list per block the gt slots that can give one of its
anchors an IoU above 0 (valid, overlapping the block's union box, and for
K1b with best > 0) in ascending slot order, start each anchor at (0, first
valid slot) and walk only that list. ``match_iou_culled`` and
``low_quality_mask_culled`` replay those steps in plain PyTorch; these
tests hold them bit for bit against the plain versions the kernels are held
against on the card (``match_iou_plain``, ``low_quality_mask_plain``), at
the kernel's block of 256 anchors and at 64, on a five-level anchor set
whose length is not a multiple of either, with adversarial gt: edges that
touch anchor edges, a box over the whole canvas, exact ties, zero-area
boxes, boxes off the canvas, an invalid first slot, an image without valid
slots, and 1 to 256 slots. Then against the Pallas kernels of the JAX
package in interpret mode: idx and mask exact, vals and best to float32
rounding (rtol 1e-6; XLA and PyTorch may round the division differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.ops import pallas_match
from aldi_tpu_torch.ops.match_kernel import (low_quality_mask_culled,
                                             low_quality_mask_plain,
                                             match_iou_culled,
                                             match_iou_plain)
from tests.torch_port_match_cases import CASES, canvas_anchors, match_case
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("case", CASES)
def test_culled_matcher_equals_plain(case, block):
    """vals, idx, the per-gt best and the low-quality mask, bit for bit."""
    anchors = torch.from_numpy(canvas_anchors())
    assert anchors.shape[0] % 64 and anchors.shape[0] % 256
    gt, valid = (torch.from_numpy(x) for x in match_case(case, anchors))
    vals, idx, best = match_iou_culled(anchors, gt, valid, block)
    w_vals, w_idx, w_best = match_iou_plain(anchors, gt, valid)
    assert torch.equal(_bits(vals), _bits(w_vals))
    assert torch.equal(idx, w_idx)
    assert torch.equal(_bits(best), _bits(w_best))
    mask = low_quality_mask_culled(anchors, gt, valid, w_best, block)
    assert torch.equal(mask, low_quality_mask_plain(anchors, gt, valid,
                                                    w_best))
    if case == "image_without_valid":
        assert (vals[1] == -1).all() and (idx[1] == 0).all()
        assert not mask[1].any()
    if case in ("random_m100", "touching_edges", "covers_canvas"):
        assert mask.any() and (vals > 0.7).any()


def test_culled_matcher_matches_pallas():
    """The replay against the Pallas kernels in interpret mode on the
    tiny canvas's 4092 anchors and 8 gt slots per image (the sizes of the
    plain versions' own Pallas test)."""
    rng = np.random.default_rng(1)
    anchors = canvas_anchors((128, 128))
    xy = rng.uniform(0, 128 - 4, (2, 8, 2))
    gt = np.concatenate([xy, xy + rng.uniform(4, 60, (2, 8, 2))],
                        -1).astype(np.float32)
    valid = np.array([[1, 0, 1, 1, 0, 1, 1, 1], [0, 1, 1, 1, 1, 1, 1, 1]],
                     bool)
    ta, tg, tv = (torch.from_numpy(x) for x in (anchors, gt, valid))
    vals, idx, best = match_iou_culled(ta, tg, tv, 256)
    mask = low_quality_mask_culled(ta, tg, tv, best, 256)
    for b in range(2):
        args = (jnp.asarray(anchors), jnp.asarray(gt[b]),
                jnp.asarray(valid[b]))
        w_vals, w_idx, w_best = pallas_match.match_iou_pallas(
            *args, interpret=True)
        np.testing.assert_allclose(vals[b].numpy(), w_vals, rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(best[b].numpy(), w_best, rtol=1e-6,
                                   atol=0)
        np.testing.assert_array_equal(idx[b].numpy(), w_idx)
        w_mask = pallas_match.low_quality_mask_pallas(*args, w_best,
                                                      interpret=True)
        np.testing.assert_array_equal(mask[b].numpy(), w_mask)
    assert mask.any()
