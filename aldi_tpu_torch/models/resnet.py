"""ResNet backbones with FrozenBN, NCHW in ``channels_last`` memory format.

Port of ``aldi_tpu/models/resnet.py``. ``ResNet`` is the detectron2
variant (the stride on the 1x1 conv by default) under detectron2's module
names (``stem.conv1``, ``res2.0.conv1``, ``...conv1.norm``);
``TorchvisionResNet`` is the JAX module's ``stride_in_1x1=False`` layout
with ``res5_dilation`` (DC5, ``:122-129,167-178``) under torchvision's
names (``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.bn1``,
``layer1.0.downsample.{0,1}``), as the Deformable DETR backbone carries
them. A reference ``.pth`` maps onto either state dict by name. FrozenBN
statistics are buffers. Every conv folds its FrozenBN affine into the
kernel in float32 and then casts, as ``aldi_tpu/models/resnet.py:93-101,
140-148`` does: conv(x, W)*s + b == conv(x, W*s) + b.

On a CUDA input of float32 or bfloat16 (``conv_epilogue.takes``) each
conv runs without its shift, and the shift, the ReLU and a bottleneck's
residual add run in one pass of the epilogue kernel
(``ops/conv_epilogue.py``): a projection shortcut's conv also runs without
its shift, its output is the residual and the two shifts are summed in
float32. Every other input, the CPU's above all, runs the ops as before.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_epilogue import conv_epilogue, takes

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


def _folded(weight, norm, dtype):
    """The kernel with the FrozenBN scale folded in, in ``dtype``, and the
    float32 shift."""
    scale, shift = norm.scale_shift()
    return (weight.float() * scale[:, None, None, None]).to(dtype), shift


def conv_frozen_bn(x, weight, norm, stride, padding, dilation, dtype):
    """conv(x, weight) followed by the FrozenBN ``norm``, folded into one
    conv in ``dtype``."""
    w, shift = _folded(weight, norm, dtype)
    return F.conv2d(x.to(dtype), w, shift.to(dtype), stride, padding,
                    dilation)


def conv_frozen_bn_parts(x, weight, norm, stride, padding, dilation, dtype):
    """``conv_frozen_bn`` without its shift, and the float32 shift: the
    conv and the bias ``conv_epilogue`` adds."""
    w, shift = _folded(weight, norm, dtype)
    return F.conv2d(x.to(dtype), w, None, stride, padding, dilation), shift


def conv_frozen_bn_relu(x, weight, norm, stride, padding, dilation, dtype):
    """relu(conv_frozen_bn(...)); the shift and the ReLU in one pass of the
    epilogue kernel where it takes x."""
    x = x.to(dtype)
    if not takes(x):
        return F.relu(conv_frozen_bn(x, weight, norm, stride, padding,
                                     dilation, dtype))
    y, shift = conv_frozen_bn_parts(x, weight, norm, stride, padding,
                                    dilation, dtype)
    return conv_epilogue(y, shift, relu=True)


def bottleneck_out(out, x, conv3, shortcut, dtype):
    """A bottleneck's end in one pass of the epilogue kernel: relu(conv3(out)
    + shortcut(x)), or + x without a shortcut. ``conv3`` and ``shortcut``
    are 1x1 convs given as (kernel, FrozenBN, stride); the shortcut conv
    runs without its shift, which joins conv3's in the bias."""
    w3, n3, s3 = conv3
    y, shift = conv_frozen_bn_parts(out, w3, n3, s3, 0, 1, dtype)
    if shortcut is None:
        return conv_epilogue(y, shift, residual=x, relu=True)
    w, n, s = shortcut
    sc, sc_shift = conv_frozen_bn_parts(x, w, n, s, 0, 1, dtype)
    return conv_epilogue(y, shift + sc_shift, residual=sc, relu=True)


def _init_conv_kernel(weight, gen):
    # variance_scaling(2.0, fan_out, normal), as the JAX package
    std = math.sqrt(2.0 / (weight.shape[0] * weight[0, 0].numel()))
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=gen) * std)


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
        return conv_frozen_bn(x, self.weight, self.norm, self.stride,
                              self.padding, 1, self.compute_dtype)

    def forward_relu(self, x):
        return conv_frozen_bn_relu(x, self.weight, self.norm, self.stride,
                                   self.padding, 1, self.compute_dtype)

    def init_weights(self, gen):
        _init_conv_kernel(self.weight, gen)


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
        dt = self.conv3.compute_dtype
        if x.dtype == dt and takes(x):
            out = self.conv2.forward_relu(self.conv1.forward_relu(x))
            sc = self.shortcut
            return bottleneck_out(
                out, x, (self.conv3.weight, self.conv3.norm, 1),
                None if sc is None else (sc.weight, sc.norm, sc.stride), dt)
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
        return F.max_pool2d(self.conv1.forward_relu(x), 3, 2, padding=1)


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


class ConvKernel(nn.Module):
    """A bias-free conv's kernel alone (torchvision's ``conv{i}``, whose
    FrozenBN is a sibling module ``bn{i}``)."""

    def __init__(self, in_channels, out_channels, kernel_size):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))

    def init_weights(self, gen):
        _init_conv_kernel(self.weight, gen)


class TorchvisionBottleneck(nn.Module):
    """torchvision's bottleneck: the stride on the 3x3 conv, which may be
    dilated; a first block's shortcut is ``downsample.{0,1}``."""

    def __init__(self, in_channels, width, out_channels, stride=1,
                 dilation=1, has_shortcut=False, compute_dtype=torch.float32):
        super().__init__()
        self.conv1 = ConvKernel(in_channels, width, 1)
        self.bn1 = FrozenBN(width)
        self.conv2 = ConvKernel(width, width, 3)
        self.bn2 = FrozenBN(width)
        self.conv3 = ConvKernel(width, out_channels, 1)
        self.bn3 = FrozenBN(out_channels)
        self.downsample = (nn.Sequential(
            ConvKernel(in_channels, out_channels, 1), FrozenBN(out_channels))
            if has_shortcut else None)
        self.stride, self.dilation = stride, dilation
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if x.dtype == dt and takes(x):
            out = conv_frozen_bn_relu(x, self.conv1.weight, self.bn1, 1, 0, 1,
                                      dt)
            out = conv_frozen_bn_relu(out, self.conv2.weight, self.bn2,
                                      self.stride, self.dilation,
                                      self.dilation, dt)
            ds = self.downsample
            return bottleneck_out(
                out, x, (self.conv3.weight, self.bn3, 1),
                None if ds is None else (ds[0].weight, ds[1], self.stride),
                dt)
        out = F.relu(conv_frozen_bn(x, self.conv1.weight, self.bn1, 1, 0, 1,
                                    dt))
        out = F.relu(conv_frozen_bn(out, self.conv2.weight, self.bn2,
                                    self.stride, self.dilation,
                                    self.dilation, dt))
        out = conv_frozen_bn(out, self.conv3.weight, self.bn3, 1, 0, 1, dt)
        sc = x if self.downsample is None else conv_frozen_bn(
            x, self.downsample[0].weight, self.downsample[1], self.stride, 0,
            1, dt)
        return F.relu(out + sc)


class TorchvisionResNet(nn.Module):
    """The JAX ``ResNet(stride_in_1x1=False)`` under torchvision's names;
    returns ``{"res2": layer1, ..., "res5": layer4}``. ``res5_dilation`` >
    1 is torchvision's ``replace_stride_with_dilation`` on layer4: stride
    1, the first block's 3x3 at dilation 1, the later blocks' at
    ``res5_dilation``. ``freeze_at`` as ``ResNet``'s (the stem is
    ``conv1``, res2..res5 are ``layer1``..``layer4``)."""

    def __init__(self, depth=50, freeze_at=0, res5_dilation=1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.freeze_at = freeze_at
        self.compute_dtype = compute_dtype
        self.conv1 = ConvKernel(3, 64, 7)
        self.bn1 = FrozenBN(64)
        in_ch, width, out_ch = 64, 64, 256
        for i, n_blocks in enumerate(BLOCKS_PER_STAGE[depth]):
            dilated = i == 3 and res5_dilation > 1
            stride = 1 if i == 0 or dilated else 2
            blocks = [TorchvisionBottleneck(
                in_ch if b == 0 else out_ch, width, out_ch,
                stride=stride if b == 0 else 1,
                dilation=res5_dilation if dilated and b > 0 else 1,
                has_shortcut=(b == 0), compute_dtype=compute_dtype)
                for b in range(n_blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            in_ch, width, out_ch = out_ch, width * 2, out_ch * 2
        if freeze_at >= 1:
            self.conv1.requires_grad_(False)
        for i in range(1, freeze_at):
            getattr(self, f"layer{i}").requires_grad_(False)

    def forward(self, x):
        out = conv_frozen_bn_relu(x, self.conv1.weight, self.bn1, 2, 3, 1,
                                  self.compute_dtype)
        out = F.max_pool2d(out, 3, 2, padding=1)
        if self.freeze_at >= 1:
            out = out.detach()
        feats = {}
        for i in range(4):
            out = getattr(self, f"layer{i + 1}")(out)
            if self.freeze_at >= i + 2:
                out = out.detach()
            feats[f"res{i + 2}"] = out
        return feats
