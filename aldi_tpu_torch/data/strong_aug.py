"""Device-side strong augmentation of a batch (the strong views of the DAOD
step), batched over images.

Port of ``aldi_tpu/data/strong_aug.py``: color jitter (contrast,
brightness, saturation @0.8) and grayscale @0.2, spatial gaussian blur
@0.5 (reflect padding, 13 taps), three random-erase passes, and MIC
masked-image block dropout. Float images in 0..255, [B, H, W, 3].

The JAX functions draw from ``jax.random`` keys; here every function takes
its draws as tensors (``strong_aug_draws`` makes them from a
``torch.Generator``), so a test can hand in the JAX package's draws. Every
function is branchless: it computes the augmented image and selects it per
image with the Bernoulli draws.
"""

import math

import torch

from ..utils.tracing import sync

_GRAY = (0.299, 0.587, 0.114)
_BLUR_RADIUS = 6  # covers 3*sigma at sigma_max=2.0

# (scale_lo, scale_hi, ratio_lo, ratio_hi, prob) per erase pass
ERASE_PASSES = (
    (0.05, 0.2, 0.3, 3.3, 0.7),
    (0.02, 0.2, 0.1, 6.0, 0.5),
    (0.02, 0.2, 0.05, 8.0, 0.3),
)


def _per_image(x):
    """[B] -> [B, 1, 1, 1], broadcastable against [B, H, W, 3]."""
    return x.reshape(-1, 1, 1, 1)


def _blend(src, dst, w):
    """D2 blend: src*(1-w) + dst*w, clipped to the uint8 range."""
    return torch.clamp(src * (1.0 - w) + dst * w, 0.0, 255.0)


def _gray(img):
    with sync("gray_weights_copy"):  # from host memory, the copy waits
        weights = torch.tensor(_GRAY, dtype=img.dtype, device=img.device)
    return (img * weights).sum(-1, keepdim=True)


def color_jitter(img, do_jitter, do_gray, factors):
    """Contrast (against the image mean), brightness (against black) and
    saturation (against the per-pixel gray) blends with factors [B, 3],
    applied where do_jitter [B]; then grayscale where do_gray [B]."""
    wc, wb, ws = (_per_image(f) for f in factors.unbind(-1))
    out_c = _blend(_per_image(img.mean(dim=(1, 2, 3))), img, wc)
    out_cb = _blend(0.0, out_c, wb)
    out_cbs = _blend(_gray(out_cb), out_cb, ws)
    out = torch.where(_per_image(do_jitter), out_cbs, img)
    return torch.where(_per_image(do_gray), _gray(out).expand_as(out), out)


def _reflect_pad(x, dim, p):
    """Reflect padding of p along ``dim`` (the edge not repeated), in the
    input's own layout: PyTorch's CUDA reflection pad writes NCHW storage,
    which would send the blurred views' NHWC images NCHW-stored into the
    backbone's convolutions."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, p).flip(dim), x,
                      x.narrow(dim, n - 1 - p, p).flip(dim)], dim)


def gaussian_blur(img, do_blur, sigma):
    """Separable spatial gaussian (13 taps, sigma [B]) with reflect padding,
    where do_blur [B]; the taps are summed in the JAX package's order."""
    p = _BLUR_RADIUS
    xs = torch.arange(-p, p + 1, dtype=torch.float32, device=img.device)
    kern = torch.exp(-0.5 * (xs / sigma[:, None]) ** 2)
    kern = kern / kern.sum(-1, keepdim=True)  # [B, 13]
    h, w = img.shape[1], img.shape[2]
    xh = _reflect_pad(img, 1, p)  # [B, H + 2p, W, 3]
    x1 = sum(xh[:, i:i + h] * _per_image(kern[:, i])
             for i in range(2 * p + 1))
    xw = _reflect_pad(x1, 2, p)
    x2 = sum(xw[:, :, i:i + w] * _per_image(kern[:, i])
             for i in range(2 * p + 1))
    return torch.where(_per_image(do_blur), torch.clamp(x2, 0.0, 255.0), img)


def random_erase(img, hw, do_erase, area_frac, aspect, y_u, x_u, noise):
    """Three passes, each filling a rectangle with ``noise`` [B, H, W, 3]
    where do_erase [B, 3]. The rectangle of pass j: area_frac[:, j] of the
    image's valid area hw [B, 2] at aspect[:, j], top-left corner at the
    fractions y_u, x_u of the room left."""
    h_img = hw[:, 0].to(torch.float32)
    w_img = hw[:, 1].to(torch.float32)
    area = h_img * w_img
    dev = img.device
    rows = torch.arange(img.shape[1], dtype=torch.float32, device=dev)
    cols = torch.arange(img.shape[2], dtype=torch.float32, device=dev)
    out = img
    for j in range(len(ERASE_PASSES)):
        target_area = area_frac[:, j] * area
        eh = torch.clamp(torch.round(torch.sqrt(target_area * aspect[:, j])),
                         torch.ones_like(h_img), h_img - 2)
        ew = torch.clamp(torch.round(torch.sqrt(target_area / aspect[:, j])),
                         torch.ones_like(w_img), w_img - 2)
        y0 = torch.floor(y_u[:, j] * (h_img - eh - 1))
        x0 = torch.floor(x_u[:, j] * (w_img - ew - 1))
        in_rows = (rows >= y0[:, None]) & (rows < (y0 + eh)[:, None])
        in_cols = (cols >= x0[:, None]) & (cols < (x0 + ew)[:, None])
        mask = (in_rows[:, :, None, None] & in_cols[:, None, :, None]
                & _per_image(do_erase[:, j]))
        out = torch.where(mask, noise, out)
    return out


def mic_grid(canvas, block_size: int):
    """(rows, cols) of the MIC block grid for a canvas (h, w)."""
    h, w = canvas
    return max(1, round(h / block_size)), max(1, round(w / block_size))


def mic_mask(img, u, ratio: float):
    """MIC block dropout: zero the blocks whose uniform u [B, mh, mw] is at
    most ``ratio``; blocks are upsampled by nearest neighbour to the
    canvas."""
    h, w = img.shape[1], img.shape[2]
    mh, mw = u.shape[1:]
    keep = (u > ratio).to(img.dtype)
    keep = keep.repeat_interleave(math.ceil(h / mh), 1)
    keep = keep.repeat_interleave(math.ceil(w / mw), 2)[:, :h, :w]
    return img * keep[..., None]


def strong_augment(images, image_sizes, draws, include_erasing=True,
                   mic=False, mic_ratio=0.5):
    """The full strong recipe: color jitter, blur, erasing (optional), MIC
    (optional). images [B, H, W, 3] in 0..255, image_sizes [B, 2] (h, w),
    draws from ``strong_aug_draws``. Returns float32 images."""
    img = images.to(torch.float32)
    img = color_jitter(img, draws["do_jitter"], draws["do_gray"],
                       draws["factors"])
    img = gaussian_blur(img, draws["do_blur"], draws["sigma"])
    if include_erasing:
        img = random_erase(img, image_sizes, draws["do_erase"],
                           draws["erase_area"], draws["erase_aspect"],
                           draws["erase_y"], draws["erase_x"],
                           draws["erase_noise"])
    if mic:
        img = mic_mask(img, draws["mic_u"], mic_ratio)
    return img


def strong_aug_draws(gen: torch.Generator, batch: int, canvas,
                     include_erasing=True, mic=False, mic_block_size=32):
    """Every draw ``strong_augment`` takes for ``batch`` images on the canvas
    (h, w), from ``gen`` on its device, with the JAX package's
    distributions."""
    def u(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=gen.device) * (
            hi - lo) + lo

    out = {"do_jitter": u(batch) < 0.8, "do_gray": u(batch) < 0.2,
           "factors": u(batch, 3, lo=0.6, hi=1.4),
           "do_blur": u(batch) < 0.5, "sigma": u(batch, lo=0.1, hi=2.0)}
    if include_erasing:
        cols = [[p[k] for p in ERASE_PASSES] for k in range(5)]
        lo_s, hi_s, lo_r, hi_r, prob = (
            torch.tensor(c, device=gen.device) for c in cols)
        out.update(
            do_erase=u(batch, 3) < prob,
            erase_area=u(batch, 3) * (hi_s - lo_s) + lo_s,
            erase_aspect=u(batch, 3) * (hi_r - lo_r) + lo_r,
            erase_y=u(batch, 3), erase_x=u(batch, 3),
            erase_noise=u(batch, *canvas, 3) * 255.0)
    if mic:
        out["mic_u"] = u(batch, *mic_grid(canvas, mic_block_size))
    return out
