"""The strong views keep the images' NHWC layout, on the CPU.

``strong_augment`` takes and returns images [B, H, W, 3]; the backbone
reads them through a ``permute`` to NCHW, so they reach the convolutions
channels-last only if their storage is NHWC (contiguous). The blur pads
with ``_reflect_pad`` in the images' own layout; these tests hold it bit
for bit against ``F.pad(..., mode="reflect")`` on the NCHW view (the
padding copies values, and the taps multiply and sum in the same order),
and check that both streams' recipes return contiguous images. The card
test of the same contract is in ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from aldi_tpu_torch.data import strong_aug
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

RECIPES = {"labeled": (True, False), "unlabeled": (False, True)}


def _images(b=3, canvas=(40, 56), seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(0, 255, (b, *canvas, 3)).astype(np.float32))


def _blur_with_f_pad(img, sigma):
    """The blur on the NCHW view with ``F.pad``'s reflect padding."""
    p = strong_aug._BLUR_RADIUS
    xs = torch.arange(-p, p + 1, dtype=torch.float32)
    kern = torch.exp(-0.5 * (xs / sigma[:, None]) ** 2)
    kern = kern / kern.sum(-1, keepdim=True)
    h, w = img.shape[1], img.shape[2]
    xh = F.pad(img.permute(0, 3, 1, 2), (0, 0, p, p), mode="reflect")
    x1 = sum(xh[:, :, i:i + h] * kern[:, i].reshape(-1, 1, 1, 1)
             for i in range(2 * p + 1))
    xw = F.pad(x1, (p, p, 0, 0), mode="reflect")
    x2 = sum(xw[:, :, :, i:i + w] * kern[:, i].reshape(-1, 1, 1, 1)
             for i in range(2 * p + 1))
    return torch.clamp(x2, 0.0, 255.0).permute(0, 2, 3, 1)


@pytest.mark.parametrize("canvas", [(40, 56), (7, 9)])
def test_gaussian_blur_equals_f_pad_reflect(canvas):
    """Every image blurred, down to a canvas of 7 rows (p = 6: the pad
    reaches the far edge)."""
    img = _images(canvas=canvas)
    sigma = torch.tensor([0.1, 1.0, 2.0])
    got = strong_aug.gaussian_blur(img, torch.ones(3, dtype=torch.bool),
                                   sigma)
    want = _blur_with_f_pad(img, sigma)
    assert torch.equal(got.view(torch.int32),
                       want.contiguous().view(torch.int32))


@pytest.mark.parametrize("stream", sorted(RECIPES))
def test_strong_augment_returns_contiguous_nhwc(stream):
    erase, mic = RECIPES[stream]
    img = _images()
    gen = torch.Generator().manual_seed(3)
    draws = strong_aug.strong_aug_draws(gen, 3, (40, 56), erase, mic, 8)
    draws["do_blur"][:] = True
    sizes = torch.tensor([[40, 56], [30, 50], [40, 40]], dtype=torch.int32)
    out = strong_aug.strong_augment(img, sizes, draws, erase, mic, 0.5)
    assert out.shape == img.shape and out.is_contiguous()
