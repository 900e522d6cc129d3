"""ViTDet backbone: plain ViT + SimpleFeaturePyramid, windowed attention.

Port of ``aldi_tpu/models/vit.py`` (detectron2's ViTDet as the reference's
``build_vitdet_b/l_backbone`` instantiates it): patch embed 16x16, absolute
position embeddings resized to the grid, decomposed relative position
embeddings, window attention (window 14) with global attention at blocks
(2, 5, 8, 11) for B / (5, 11, 17, 23) for L, drop path, and the
SimpleFeaturePyramid (scales 4, 2, 1, 0.5 and a max-pooled p6). Module
names follow detectron2 (``net.blocks.{i}.attn.qkv``,
``simfp_{2..5}.{slot}``).

What is kept of the JAX package's arithmetic:
- ``get_abs_pos`` resizes as ``jax.image.resize(..., "bicubic")`` does
  (Keys a=-0.5, half-pixel centres, taps outside the input dropped and the
  rest renormalised, antialiased when shrinking), not as
  ``F.interpolate(mode="bicubic")`` (a=-0.75, clamped borders); the
  ``linear`` resize of ``get_rel_pos`` likewise.
- LayerNorm has eps 1e-6 (flax's) and runs in float32 before the cast; GELU
  is exact.
- Window attention: float32 logits from ``q * scale`` in the compute dtype,
  float32 softmax, cast, then P.V; the 64x128 grid pads to 70x140 (50
  windows) with no mask on the padding.
- Global blocks (every size) go through ``ops.flash_attn``: the bias from
  the unscaled q in float32, only the logits scaled; the CUDA kernels K3a
  and K3b on the card.
- Drop path takes its keep masks as tensors (``drop`` [2, depth, B]: the
  attention and the MLP branch of every block), drawn by
  ``engine.train_step.draw_step``; without them (teacher, serving) it is
  the identity. ``VIT.USE_ACT_CHECKPOINT`` is
  ``torch.utils.checkpoint(use_reentrant=False)`` per block: the
  recomputed forward takes the same masks, and launches K3a again.
"""

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import precision
from ..ops.flash_attn import flash_attention_relpos
from .layers import (ChannelLayerNorm, DenseConv2d, DenseConvNorm,
                     DenseLinear, LayerNorm, lecun_normal, layer_norm)

VIT_CONFIGS = {
    "b": dict(embed_dim=768, depth=12, num_heads=12, drop_path_rate=0.1,
              global_blocks=(2, 5, 8, 11)),
    "l": dict(embed_dim=1024, depth=24, num_heads=16, drop_path_rate=0.4,
              global_blocks=(5, 11, 17, 23)),
}


# ------------------------------------------------------------ resizing
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weights(in_size: int, out_size: int, kernel: str) -> np.ndarray:
    """[in_size, out_size] float32 weights of ``jax.image.resize`` along one
    axis (``jax._src.image.scale.compute_weight_mat`` with antialiasing):
    ``kernel`` is "cubic" (Keys, a=-0.5) or "linear"."""
    f = np.float32
    inv_scale = f(1.0) / (f(out_size) / f(in_size))
    kernel_scale = max(inv_scale, f(1.0))
    sample = ((np.arange(out_size, dtype=f) + f(0.5)) * inv_scale - f(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) \
        / kernel_scale
    w = (_keys_cubic if kernel == "cubic" else _triangle)(x).astype(f)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f)


def _weights(in_size, out_size, kernel, like):
    return torch.from_numpy(resize_weights(in_size, out_size, kernel)).to(
        device=like.device, dtype=like.dtype)


def get_abs_pos(pos_embed: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Resize [1, P, P, D] pretrain position embeddings to (H, W) as
    ``jax.image.resize(..., "bicubic")``: two small matmuls."""
    h, w = hw
    if pos_embed.shape[1] == h and pos_embed.shape[2] == w:
        return pos_embed
    wh = _weights(pos_embed.shape[1], h, "cubic", pos_embed)
    ww = _weights(pos_embed.shape[2], w, "cubic", pos_embed)
    x = torch.einsum("bpqc,py->byqc", pos_embed, wh)
    return torch.einsum("byqc,qx->byxc", x, ww)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """[2*max(q,k)-1, C] table -> [q, k, C] lookups; a table of another
    length is first resized linearly along its first axis, as
    ``jax.image.resize(..., "linear")``."""
    max_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_dist:
        rel_pos = torch.einsum(
            "ic,io->oc", rel_pos,
            _weights(rel_pos.shape[0], max_dist, "linear", rel_pos))
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[torch.from_numpy(rel.astype(np.int64)).to(rel_pos.device)]


# -------------------------------------------------------------- layers
class ConvTranspose2d(nn.ConvTranspose2d):
    """2x2 stride-2 deconv with float32 parameters computing in
    ``compute_dtype``."""

    def __init__(self, in_channels, out_channels, compute_dtype):
        super().__init__(in_channels, out_channels, 2, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return precision.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                          self.bias.to(dt), stride=2)

    def init_weights(self, gen):
        # flax lecun_normal over the kernel's fan in (kH * kW * in)
        fan_in = self.weight.shape[0] * 4
        lecun_normal(self.weight, fan_in, gen)
        nn.init.zeros_(self.bias)


# ------------------------------------------------------------ attention
class Attention(nn.Module):
    """Multi-head attention with decomposed rel-pos bias over a
    [B, H, W, C] map. ``qkv`` is detectron2's [3C, C] Linear (output order
    (3, heads, head_dim)); ``use_kernel`` sends the attention through
    ``flash_attention_relpos`` (the global blocks)."""

    def __init__(self, dim, num_heads, input_size, use_kernel,
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.use_kernel = use_kernel
        self.compute_dtype = compute_dtype
        self.qkv = DenseLinear(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = DenseLinear(dim, dim, compute_dtype=compute_dtype)
        h, w = input_size
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, self.head_dim))

    def init_weights(self, gen):
        nn.init.zeros_(self.rel_pos_h)
        nn.init.zeros_(self.rel_pos_w)

    def forward(self, x):
        b, h, w, _ = x.shape
        nh, hd, n = self.num_heads, self.head_dim, h * w
        qkv = self.qkv(x).reshape(b, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)  # [B, nh, N, hd]
        scale = hd ** -0.5
        tables = self.rel_pos_h, self.rel_pos_w
        rh = get_rel_pos(h, h, tables[0].float())  # [h, h, hd]
        rw = get_rel_pos(w, w, tables[1].float())
        rq = q.reshape(b, nh, h, w, hd).float()
        bias_h = torch.einsum("bnhwd,hkd->bnhwk", rq, rh)
        bias_w = torch.einsum("bnhwd,wkd->bnhwk", rq, rw)
        if self.use_kernel:
            g = b * nh
            out = flash_attention_relpos(
                q.reshape(g, n, hd), k.reshape(g, n, hd), v.reshape(g, n, hd),
                bias_h.reshape(g, n, h), bias_w.reshape(g, n, w), scale, h,
                w).reshape(b, nh, n, hd)
        else:
            attn = precision.matmul((q * scale).float(),
                                    k.float().transpose(-1, -2))
            attn = (attn.reshape(b, nh, h, w, h, w) + bias_h[..., :, None]
                    + bias_w[..., None, :]).reshape(b, nh, n, n)
            attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
            out = precision.matmul(attn, v)
        out = out.permute(0, 2, 1, 3).reshape(b, h, w, nh * hd)
        return self.proj(out)


def window_partition(x, window: int):
    b, h, w, c = x.shape
    ph = (window - h % window) % window
    pw = (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(x, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // (hp * wp // window // window)
    x = x.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class Mlp(nn.Module):
    def __init__(self, dim, hidden, compute_dtype):
        super().__init__()
        self.fc1 = DenseLinear(dim, hidden, compute_dtype=compute_dtype)
        self.fc2 = DenseLinear(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block; ``window_size`` 0 is global attention
    over ``grid``."""

    def __init__(self, dim, num_heads, window_size, grid, drop_path=0.0,
                 mlp_ratio=4.0, compute_dtype=torch.float32):
        super().__init__()
        self.window_size = window_size
        self.drop_path = drop_path
        self.compute_dtype = compute_dtype
        self.norm1 = LayerNorm(dim)
        size = (window_size, window_size) if window_size else tuple(grid)
        self.attn = Attention(dim, num_heads, size, use_kernel=not window_size,
                              compute_dtype=compute_dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype)

    def _drop(self, y, keep_mask):
        """Drop path with given keep flags [B] (None: the identity)."""
        if keep_mask is None or self.drop_path == 0.0:
            return y
        keep = 1.0 - self.drop_path
        return y * keep_mask.to(y.dtype)[:, None, None, None] / keep

    def forward(self, x, attn_keep=None, mlp_keep=None):
        dt = self.compute_dtype
        shortcut = x
        y = layer_norm(x, self.norm1, dt)
        hw = (y.shape[1], y.shape[2])
        if self.window_size:
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size:
            y = window_unpartition(y, self.window_size, pad_hw, hw)
        x = shortcut + self._drop(y, attn_keep)
        y = self.mlp(layer_norm(x, self.norm2, dt))
        return x + self._drop(y, mlp_keep)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim, compute_dtype):
        super().__init__()
        self.proj = DenseConv2d(3, embed_dim, patch_size, stride=patch_size,
                                compute_dtype=compute_dtype)

    def forward(self, x):  # NCHW -> NHWC
        return self.proj(x).permute(0, 2, 3, 1)


class ViT(nn.Module):
    """Plain ViT trunk over the canvas's (H/16, W/16) grid: NCHW images ->
    the stride-16 map NHWC."""

    def __init__(self, grid, embed_dim=768, depth=12, num_heads=12,
                 patch_size=16, window_size=14,
                 global_blocks: Sequence[int] = (2, 5, 8, 11),
                 drop_path_rate=0.1, pretrain_img_size=224,
                 use_act_checkpoint=True, compute_dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.use_act_checkpoint = use_act_checkpoint
        self.patch_embed = PatchEmbed(patch_size, embed_dim, compute_dtype)
        p = pretrain_img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, p, p, embed_dim))
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads,
                  0 if i in global_blocks else window_size, grid,
                  drop_path_rate * i / max(depth - 1, 1),
                  compute_dtype=compute_dtype)
            for i in range(depth)])

    def init_weights(self, gen):
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04,
                                  generator=gen)

    def keep_rates(self):
        """The keep probability of each block's drop path, per branch
        [2 (attention, MLP), depth]: the leading shape of the keep masks
        ``forward`` takes."""
        return torch.tensor([1.0 - blk.drop_path
                             for blk in self.blocks]).expand(2, -1)

    def forward(self, x, drop=None):
        """``drop``: keep masks [2, depth, B] for drop path, or None."""
        x = self.patch_embed(x)
        x = x + get_abs_pos(self.pos_embed.float(),
                            (x.shape[1], x.shape[2])).to(x.dtype)
        for i, block in enumerate(self.blocks):
            masks = (None, None) if drop is None else (drop[0, i], drop[1, i])
            if self.use_act_checkpoint and torch.is_grad_enabled():
                x = checkpoint(block, x, *masks, use_reentrant=False)
            else:
                x = block(x, *masks)
        return x


class SimpleFeaturePyramid(nn.Module):
    """The trunk's stride-16 map -> [p2, ..., p6] NCHW: per scale
    [deconv]* -> 1x1 conv + LN -> 3x3 conv + LN; p6 = max_pool(p5, 1,
    stride 2). ``simfp_{2..5}`` are detectron2's Sequential slots."""

    def __init__(self, dim, out_channels=256, compute_dtype=torch.float32):
        super().__init__()
        dt = compute_dtype

        def convs(cin):
            return [DenseConvNorm(cin, out_channels, 1, compute_dtype=dt),
                    DenseConvNorm(out_channels, out_channels, 3,
                                  compute_dtype=dt)]

        self.simfp_2 = nn.Sequential(
            ConvTranspose2d(dim, dim // 2, dt), ChannelLayerNorm(dim // 2, dt),
            nn.GELU(), ConvTranspose2d(dim // 2, dim // 4, dt),
            *convs(dim // 4))
        self.simfp_3 = nn.Sequential(ConvTranspose2d(dim, dim // 2, dt),
                                     *convs(dim // 2))
        self.simfp_4 = nn.Sequential(*convs(dim))
        self.simfp_5 = nn.Sequential(nn.MaxPool2d(2, 2), *convs(dim))

    def forward(self, x):  # NHWC -> NCHW levels
        x = x.permute(0, 3, 1, 2)
        outs = [getattr(self, f"simfp_{s}")(x) for s in (2, 3, 4, 5)]
        outs.append(F.max_pool2d(outs[-1], kernel_size=1, stride=2))
        return outs


class ViTDetBackbone(SimpleFeaturePyramid):
    """``net`` (the ViT of ``VIT_CONFIGS[size]``) under the
    SimpleFeaturePyramid's ``simfp_*``, as detectron2 names them: NCHW
    images -> [p2, ..., p6] NCHW."""

    def __init__(self, size, grid, out_channels=256, use_act_checkpoint=True,
                 compute_dtype=torch.float32):
        cfg = VIT_CONFIGS[size]
        super().__init__(cfg["embed_dim"], out_channels, compute_dtype)
        self.net = ViT(grid, use_act_checkpoint=use_act_checkpoint,
                       compute_dtype=compute_dtype, **cfg)

    def keep_rates(self):
        return self.net.keep_rates()

    def forward(self, x, drop=None):
        """``drop``: the ViT's drop-path keep masks, or None."""
        return super().forward(self.net(x, drop))
