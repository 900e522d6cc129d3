"""Conv and linear layers that keep float32 parameters and compute in a
given dtype, as flax's ``nn.Conv(dtype=...)``/``nn.Dense(dtype=...)`` do in
the JAX package, with the JAX package's initializers."""

import math

import torch
import torch.nn.functional as F
from torch import nn


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
