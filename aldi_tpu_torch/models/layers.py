"""Conv and linear layers that keep float32 parameters and compute in a
given dtype, as flax's ``nn.Conv(dtype=...)``/``nn.Dense(dtype=...)`` do in
the JAX package, with the JAX package's initializers; and flax's LayerNorm
(eps 1e-6, float32 statistics, then the cast)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_epilogue import conv_epilogue, takes


def _init_weight(weight, fan_in, std, gen):
    """``std=None``: variance_scaling(1, fan_in, uniform) (the c2 xavier of
    the FPN and box-head layers); else normal(std)."""
    with torch.no_grad():
        if std is None:
            bound = math.sqrt(3.0 / fan_in)
            t = torch.rand(weight.shape, generator=gen) * (2 * bound) - bound
        else:
            t = torch.randn(weight.shape, generator=gen) * std
        weight.copy_(t)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters whose arithmetic runs in
    ``compute_dtype``."""

    def __init__(self, in_channels, out_channels, kernel_size, *,
                 compute_dtype=torch.float32, init_std=None, **kwargs):
        super().__init__(in_channels, out_channels, kernel_size, **kwargs)
        self.compute_dtype = compute_dtype
        self.init_std = init_std

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                        self.padding, self.dilation, self.groups)

    def forward_fused(self, x, relu=False, coarse=None):
        """``forward``, plus the nearest 2x upsampling of ``coarse`` (the
        FPN's top-down add) and a ReLU where asked. Where the epilogue
        kernel takes the input and ``coarse`` (``conv_epilogue.takes``) the
        conv runs without its bias and the rest in one pass of the kernel;
        elsewhere, as separate ops."""
        dt = self.compute_dtype
        x = x.to(dt)
        extra = () if coarse is None else (coarse,)
        if self.bias is None or not takes(x, *extra):
            out = self.forward(x)
            if coarse is not None:
                out = out + F.interpolate(coarse, scale_factor=2,
                                          mode="nearest")
            return F.relu(out) if relu else out
        y = F.conv2d(x, self.weight.to(dt), None, self.stride, self.padding,
                     self.dilation, self.groups)
        return conv_epilogue(y, self.bias, coarse=coarse, relu=relu)

    def init_weights(self, gen):
        fan_in = self.weight[0].numel()
        _init_weight(self.weight, fan_in, self.init_std, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters whose arithmetic runs in
    ``compute_dtype``."""

    def __init__(self, in_features, out_features, *,
                 compute_dtype=torch.float32, init_std=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self.init_std = init_std

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def init_weights(self, gen):
        _init_weight(self.weight, self.in_features, self.init_std, gen)
        nn.init.zeros_(self.bias)


LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def layer_norm(x, norm, dtype):
    """flax ``LayerNorm(dtype=float32)``: float32 statistics, eps 1e-6, then
    the cast to the compute dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], norm.weight, norm.bias,
                        LN_EPS).to(dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with eps 1e-6 (flax's default)."""

    def __init__(self, dim):
        super().__init__(dim, eps=LN_EPS)

    def init_weights(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class ChannelLayerNorm(LayerNorm):
    """LayerNorm over the channels of an NCHW tensor (float32, then cast to
    ``compute_dtype``)."""

    def __init__(self, dim, compute_dtype=torch.float32):
        super().__init__(dim)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return layer_norm(x.permute(0, 2, 3, 1), self,
                          self.compute_dtype).permute(0, 3, 1, 2)


class ConvNorm(Conv2d):
    """Bias-free conv followed by a channel LayerNorm (detectron2's
    ``Conv2d(norm=LayerNorm)``: ``{name}.weight``, ``{name}.norm.*``)."""

    def __init__(self, in_channels, out_channels, kernel_size, *,
                 compute_dtype=torch.float32, init_std=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2, bias=False,
                         compute_dtype=compute_dtype, init_std=init_std)
        self.norm = ChannelLayerNorm(out_channels, compute_dtype)

    def forward(self, x):
        return self.norm(super().forward(x))


def lecun_normal(weight, fan_in, gen):
    """flax ``lecun_normal``: truncated normal (+-2 std) with the variance
    1/fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                              generator=gen)


class _DenseInit:
    """flax ``nn.Dense``/``nn.Conv`` default initializers."""

    def init_weights(self, gen):
        lecun_normal(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class DenseLinear(_DenseInit, Linear):
    pass


class DenseConv2d(_DenseInit, Conv2d):
    pass


class DenseConvNorm(_DenseInit, ConvNorm):
    pass
