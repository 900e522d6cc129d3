"""Attention with the decomposed relative-position bias of the ViTDet global
blocks: ``softmax(q k^T * scale + Bh[q, y_k] + Bw[q, x_k]) v``, in plain
PyTorch and differentiated by autograd.

q/k/v are [G, N, D] with G = batch * heads and the keys in raster order
(key k at grid cell (y, x) = (k // w_grid, k % w_grid)); bh is
[G, N, h_grid], bw [G, N, w_grid]. The [N, N] logits of a few heads are
held at a time: each chunk of heads runs under activation checkpointing,
so its logits are made again in the backward instead of being kept.
"""

import torch
from torch.utils.checkpoint import checkpoint

from .. import precision

# [G, N, N] float32 elements one chunk holds at once (1 GiB)
_CHUNK = 1 << 28


def _attend(q, k, v, bh, bw, scale, h_grid, w_grid):
    n = q.shape[1]
    keys = torch.arange(n, device=q.device)
    s = precision.matmul(q.float(), k.float().transpose(1, 2)) * scale
    s = s + bh.float()[:, :, keys // w_grid] + bw.float()[:, :, keys % w_grid]
    return precision.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def flash_attention_relpos(q, k, v, bh, bw, scale, h_grid, w_grid):
    """Exact softmax(q k^T * scale + decomposed rel-pos bias) v, [G, N, D],
    differentiable in q, k, v, bh and bw. The bias is not scaled."""
    g, n = q.shape[:2]
    step = max(1, _CHUNK // max(n * n, 1))
    outs = []
    for s in range(0, g, step):
        part = [t[s:s + step] for t in (q, k, v, bh, bw)]
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend, *part, scale, h_grid, w_grid,
                                   use_reentrant=False))
        else:
            outs.append(_attend(*part, scale, h_grid, w_grid))
    return torch.cat(outs)
