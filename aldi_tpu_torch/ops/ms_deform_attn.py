"""Multi-scale deformable attention sampling (the MSDeformAttn core).

Counterpart of ``aldi_tpu/ops/ms_deform_attn.py:61`` ``ms_deform_attn_core``
(XLA gathers there, no Pallas kernel): at each sampling location a bilinear
sample of its level's value map (``align_corners=False``: pixel = loc * size
- 0.5; zero outside the level), weighted by the attention weight and summed
over the levels and points of each head. It is written the way the official
Deformable-DETR's pure-PyTorch fallback writes the op: one
``F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=False)`` per level on ``[B*H, D, h_l, w_l]`` with the grid
``2 * loc - 1``. That library call is used here because the JAX function is
not a TPU kernel: no hand-written kernel is owed for it. The JAX file's
quad tables and query chunks are TPU layout devices and have no
counterpart.

Dtypes: the sampling runs in the value's dtype (float32 at the published
``SOLVER.AMP.ENABLED: false``; bfloat16 when ``TPU.COMPUTE_DTYPE`` asks for
it), the attention weights multiply in float32 and the sum over levels and
points accumulates in float32, as the JAX function's does.
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def ms_deform_attn_core(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        locations: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """value [B, Lv, H, D] (the levels flattened in order), locations
    [B, Lq, H, L, P, 2] normalized (x, y), weights [B, Lq, H, L, P] ->
    [B, Lq, H*D] float32."""
    b, _, h, d = value.shape
    lq, n_points = locations.shape[1], locations.shape[4]
    grids = 2 * locations.to(value.dtype) - 1
    w = weights.float()
    out = None
    start = 0
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        v = value[:, start:start + hh * ww]
        start += hh * ww
        v = v.permute(0, 2, 3, 1).reshape(b * h, d, hh, ww)
        g = grids[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(
            b * h, lq, n_points, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)  # [B*H, D, Lq, P]
        wl = w[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * h, 1, lq,
                                                         n_points)
        part = (s.float() * wl).sum(-1)  # [B*H, D, Lq]
        out = part if out is None else out + part
    return out.reshape(b, h * d, lq).transpose(1, 2)
