"""ConvNeXt backbone.

Port of ``aldi_tpu/models/convnext.py:22-97`` (the reference's vendored
ConvNeXt, ``aldi/backbone.py:155-355``) under the reference's module names,
``backbone.bottom_up.{downsample_layers,stages,norm{i}}``:
``downsample_layers.{i}`` is [conv 4x4/4, LN] for i = 0 and [LN, conv
2x2/2] after; ``stages.{i}.{j}`` a block of a 7x7 depthwise conv
(``dwconv``), a LayerNorm (``norm``), a 4x MLP with exact GELU
(``pwconv1``, ``pwconv2``) and the layer scale ``gamma``; ``norm{i}`` the
LayerNorm of each stage's output.

What is kept of the JAX package's arithmetic: every LayerNorm runs in
float32 with eps 1e-6 and is cast back to the compute dtype; drop path
multiplies the block's branch by its keep flag and divides by the keep
rate, only in blocks whose rate ``drop_path_rate * i / (depth - 1)`` is
above 0. The keep flags are tensors (``drop`` [sum(depths), B], drawn by
``engine.train_step.draw_step``); without them (teacher, serving) drop
path is the identity. There is no activation checkpointing, as in the JAX
package.

Layout: NCHW views of channels-last memory in and out, as the ResNet's.
The convolutions take that view; the LayerNorms, the MLP, the layer scale
and drop path run on ``permute(0, 2, 3, 1)``, a contiguous NHWC view, so
the residual stream never leaves channels-last memory.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import DenseConv2d, DenseLinear, LayerNorm, layer_norm


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear 4x -> GELU -> Linear -> gamma -> drop
    path, plus the shortcut."""

    def __init__(self, dim, drop_path=0.0, layer_scale_init=1e-6,
                 compute_dtype=torch.float32):
        super().__init__()
        self.drop_path = drop_path
        self.layer_scale_init = layer_scale_init
        self.compute_dtype = compute_dtype
        self.dwconv = DenseConv2d(dim, dim, 7, padding=3, groups=dim,
                                  compute_dtype=compute_dtype)
        self.norm = LayerNorm(dim)
        self.pwconv1 = DenseLinear(dim, 4 * dim, compute_dtype=compute_dtype)
        self.pwconv2 = DenseLinear(4 * dim, dim, compute_dtype=compute_dtype)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init))
                      if layer_scale_init > 0 else None)

    def init_weights(self, gen):
        if self.gamma is not None:
            nn.init.constant_(self.gamma, self.layer_scale_init)

    def forward(self, x, keep=None):
        """x NCHW (channels-last memory); ``keep``: drop-path keep flags
        [B], or None (the identity)."""
        dt = self.compute_dtype
        y = layer_norm(_nhwc(self.dwconv(x)), self.norm, dt)
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        if keep is not None and self.drop_path > 0.0:
            rate = 1.0 - self.drop_path
            y = y * keep.to(y.dtype)[:, None, None, None] / rate
        return x + _nchw(y)


class ConvNeXt(nn.Module):
    """NCHW images -> {"res2": ..., "res5": ...} (strides 4/8/16/32), each
    after its stage's output LayerNorm."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 drop_path_rate=0.2, layer_scale_init=1e-6,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_channels = {f"res{i + 2}": d for i, d in enumerate(dims)}
        total = sum(depths)
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        dt = compute_dtype
        self.downsample_layers = nn.ModuleList([nn.ModuleList([
            DenseConv2d(3, dims[0], 4, stride=4, compute_dtype=dt),
            LayerNorm(dims[0])])])
        for i in range(1, 4):
            self.downsample_layers.append(nn.ModuleList([
                LayerNorm(dims[i - 1]),
                DenseConv2d(dims[i - 1], dims[i], 2, stride=2,
                            compute_dtype=dt)]))
        self.stages = nn.ModuleList()
        cur = 0
        for i, depth in enumerate(depths):
            self.stages.append(nn.ModuleList([
                ConvNeXtBlock(dims[i], rates[cur + j], layer_scale_init, dt)
                for j in range(depth)]))
            cur += depth
        for i, d in enumerate(dims):
            self.add_module(f"norm{i}", LayerNorm(d))

    def keep_rates(self):
        """The keep probability of each block's drop path [sum(depths)]:
        the leading shape of the keep masks ``forward`` takes."""
        return torch.tensor([1.0 - blk.drop_path for stage in self.stages
                             for blk in stage])

    def _norm(self, x, norm):
        return _nchw(layer_norm(_nhwc(x), norm, self.compute_dtype))

    def forward(self, x, drop=None):
        """``drop``: keep flags [sum(depths), B] for drop path, or None."""
        feats = {}
        cur = 0
        for i, stage in enumerate(self.stages):
            a, b = self.downsample_layers[i]
            x = self._norm(a(x), b) if i == 0 else b(self._norm(x, a))
            for blk in stage:
                x = blk(x, None if drop is None else drop[cur])
                cur += 1
            feats[f"res{i + 2}"] = self._norm(x, getattr(self, f"norm{i}"))
        return feats
