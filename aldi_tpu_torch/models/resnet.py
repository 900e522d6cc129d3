"""ResNet backbone (D2-compatible variant) with FrozenBN, NCHW in
``channels_last`` memory format.

Port of ``aldi_tpu/models/resnet.py``. Module names follow detectron2
(``stem.conv1``, ``res2.0.conv1``, ``...conv1.norm``), so a reference
``.pth`` maps onto the state dict by name. FrozenBN statistics are buffers.
Every conv folds its FrozenBN affine into the kernel in float32 and then
casts, as ``aldi_tpu/models/resnet.py:93-101,140-148`` does:
conv(x, W)*s + b == conv(x, W*s) + b.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

BLOCKS_PER_STAGE = {26: [1, 1, 1, 1], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


class FrozenBN(nn.Module):
    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((num_features,), fill))

    def scale_shift(self):
        """The float32 ``(scale, shift)`` of the frozen affine."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale


class ConvFrozenBN(nn.Module):
    """Bias-free conv followed by FrozenBN, folded into one conv."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.norm = FrozenBN(out_channels)
        self.stride = stride
        self.padding = kernel_size // 2
        self.compute_dtype = compute_dtype

    def forward(self, x):
        scale, shift = self.norm.scale_shift()
        dt = self.compute_dtype
        w = (self.weight.float() * scale[:, None, None, None]).to(dt)
        return F.conv2d(x.to(dt), w, shift.to(dt), self.stride, self.padding)

    def init_weights(self, gen):
        # variance_scaling(2.0, fan_out, normal), as the JAX package
        std = math.sqrt(2.0 / (self.weight.shape[0] * self.weight[0, 0].numel()))
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=gen)
                              * std)


class Bottleneck(nn.Module):
    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, stride_in_1x1=True, has_shortcut=False,
                 compute_dtype=torch.float32):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        dt = compute_dtype
        self.conv1 = ConvFrozenBN(in_channels, bottleneck_channels, 1, s1, dt)
        self.conv2 = ConvFrozenBN(bottleneck_channels, bottleneck_channels, 3,
                                  s3, dt)
        self.conv3 = ConvFrozenBN(bottleneck_channels, out_channels, 1, 1, dt)
        self.shortcut = (ConvFrozenBN(in_channels, out_channels, 1, stride, dt)
                         if has_shortcut else None)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


class BasicStem(nn.Module):
    """7x7/2 conv + 3x3/2 max-pool."""

    def __init__(self, compute_dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvFrozenBN(3, 64, 7, 2, compute_dtype)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, padding=1)


class ResNet(nn.Module):
    """Returns the stage outputs ``{"res2": ..., ..., "res5": ...}``.

    ``freeze_at`` (``MODEL.BACKBONE.FREEZE_AT``) freezes the stem (>= 1) and
    the stages res2..res{freeze_at}: their outputs are detached at the
    points where ``aldi_tpu/models/resnet.py:159-160,185-186`` stops the
    gradient, and their parameters have ``requires_grad=False``, so they
    stay out of the optimizer (``aldi_tpu/solver.py:120-138`` masks them).
    """

    out_channels = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}

    def __init__(self, depth=50, stride_in_1x1=True,
                 compute_dtype=torch.float32, freeze_at=0):
        super().__init__()
        self.freeze_at = freeze_at
        self.stem = BasicStem(compute_dtype)
        in_ch, bott_ch, out_ch = 64, 64, 256
        self.stage_names = []
        for i, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            name = f"res{i + 2}"
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(
                    in_ch if b == 0 else out_ch, bott_ch, out_ch,
                    stride=(1 if i == 0 else 2) if b == 0 else 1,
                    stride_in_1x1=stride_in_1x1, has_shortcut=(b == 0),
                    compute_dtype=compute_dtype))
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            in_ch, bott_ch, out_ch = out_ch, bott_ch * 2, out_ch * 2
        frozen = (["stem"] * (freeze_at >= 1)
                  + self.stage_names[:max(freeze_at - 1, 0)])
        for name in frozen:
            getattr(self, name).requires_grad_(False)

    def forward(self, x):
        out = self.stem(x)
        if self.freeze_at >= 1:
            out = out.detach()
        feats = {}
        for i, name in enumerate(self.stage_names):
            out = getattr(self, name)(out)
            if self.freeze_at >= i + 2:
                out = out.detach()
            feats[name] = out
        return feats
