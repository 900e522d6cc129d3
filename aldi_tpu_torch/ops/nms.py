"""Padded, fixed-shape non-maximum suppression, batched over leading dims.

Port of ``aldi_tpu/ops/nms.py`` (plain XLA there, plain PyTorch here).

Algorithm: exact greedy NMS via fixed-point iteration. With boxes sorted by
descending score and S[j, i] = (iou > t, j < i), greedy keep is the unique
fixed point of ``keep = valid & ~(keep @ S)``. After t iterations the first
t sorted positions are final, so it converges in <= N steps; in practice a
handful. Every (image, level) pair runs in one batched ``[G, N, N]`` loop,
and the host checks for convergence only every ``_CHECK_EVERY`` steps:
steps past the fixed point leave it unchanged. Under ``torch.export`` the
same steps run as a ``while_loop`` (``_fixed_point_traced``). Under a
profiler the eager loop is the range ``aldi/nms`` and each exit test
``aldi/sync/nms_exit`` (``utils/tracing.py``).
"""

import torch

from ..utils.tracing import span, sync
from .boxes import pairwise_iou

_CHECK_EVERY = 8


def _steps(keep, v, supp):
    """``_CHECK_EVERY`` steps of ``keep = v & ~(keep @ S)``: (keep, the
    keep of the step before the last)."""
    for _ in range(_CHECK_EVERY):
        prev = keep
        removed = torch.bmm(keep.to(torch.float32)[:, None, :],
                            supp)[:, 0] > 0.0
        keep = v & ~removed
    return keep, prev


def _fixed_point_traced(v, supp):
    """The fixed-point loop as a ``while_loop`` the tracer keeps in the
    graph (``torch.export`` cannot keep the eager loop's data-dependent
    exit): the same ``_steps`` bodies while the last step changed keep and
    fewer than N steps ran (``aldi_tpu/ops/nms.py:48-58``). The first body
    runs before the loop, as the eager loop's does: a ``while_loop`` reads
    its condition on the host before every body, and a read before the
    first would add one synchronization per call. Eagerly, ``while_loop``
    would compile through dynamo, so only a traced call takes this form."""
    from torch._higher_order_ops import while_loop

    n = v.shape[-1]

    def cond(keep, changed, steps):
        return changed & (steps < n)

    def body(keep, changed, steps):
        keep, prev = _steps(keep, v, supp)
        return keep, (keep != prev).any(), steps + _CHECK_EVERY

    keep, prev = _steps(v, v, supp)
    keep, _, _ = while_loop(cond, body, (
        keep, (keep != prev).any(),
        torch.full((), _CHECK_EVERY, dtype=torch.int64, device=v.device)))
    return keep


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Exact greedy NMS over the last axis. boxes [..., N, 4], scores
    [..., N], valid [..., N] -> bool keep mask [..., N] in input order."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    valid = valid.reshape(-1, n)
    neg_inf = torch.full_like(scores, -torch.inf)
    # stable DESCENDING sort: among tied scores the lower-index box is
    # processed (and kept) first, as in torchvision/detectron2 greedy NMS
    order = torch.sort(torch.where(valid, scores, neg_inf), dim=-1,
                       descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)

    upper = torch.ones((n, n), dtype=torch.bool,
                       device=boxes.device).triu(diagonal=1)
    supp = ((pairwise_iou(b, b) > iou_threshold) & upper
            & v[:, :, None] & v[:, None, :]).to(torch.float32)

    if torch.compiler.is_exporting():
        keep = _fixed_point_traced(v, supp)
    else:
        keep = v
        with span("nms"):
            for _ in range(0, n, _CHECK_EVERY):
                keep, prev = _steps(keep, v, supp)
                with sync("nms_exit"):
                    if torch.equal(keep, prev):
                        break

    out = torch.zeros_like(keep).scatter_(1, order, keep)
    return out.reshape(lead + (n,))


def batched_nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                          idxs: torch.Tensor, valid: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """Category-aware NMS over the last axis: boxes of different ``idxs``
    never suppress each other (substrate ``batched_nms`` semantics), by
    offsetting each category into a disjoint coordinate range."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(-2, -1), keepdim=True) + 1.0  # [..., 1, 1]
    shifted = boxes + idxs.to(boxes.dtype)[..., None] * max_coord
    return nms_keep_mask(shifted, scores, valid, iou_threshold)


def top_k(x: torch.Tensor, k: int):
    """The k largest values along the last dim and their indices, sorted,
    the lower index first among equal values, as ``jax.lax.top_k`` orders
    them (``torch.topk`` leaves the order of ties, and so which of them
    make the cut, unspecified: flat image regions, the canvas's padding
    among them, give exactly tied logits)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def top_k_by_score(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, k: int):
    """Top-k rows by score among valid ones, over the second-last axis of
    boxes [..., N, 4]. Returns (boxes [..., k, 4], scores [..., k],
    valid [..., k])."""
    s = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    vals, idx = top_k(s, k)
    top_boxes = torch.gather(
        boxes, -2, idx[..., None].expand(idx.shape + (4,)))
    return (top_boxes, vals,
            torch.gather(valid, -1, idx) & torch.isfinite(vals))
