"""Anchor <-> ground-truth matching: the CUDA kernels K1a/K1b
(``csrc/match_iou.cu``), their plain PyTorch versions, and ``match_boxes``.

Counterpart of ``aldi_tpu/ops/pallas_match.py``: ``match_iou`` replaces
``match_iou_pallas`` (``:67``) and ``low_quality_mask`` replaces
``low_quality_mask_pallas`` (``:139``); the source says what bounds them on
the card. Unlike the Pallas kernels, one launch covers every image of the
batch. ``match_boxes`` calls them as the custom ops of ``custom_ops.py``,
whose dispatcher sends CPU tensors to the plain versions and CUDA tensors
to the kernels; it never falls back. ``match_boxes_plain``
(``pairwise_iou`` + ``matcher.match``) is the same function, for the
tests. The libraries are built on the first launch, never on
import. ``match_iou_culled`` and ``low_quality_mask_culled`` replay the
kernels' per-block gt culling in plain PyTorch, for the tests; nothing on
the training path calls them.
"""

import ctypes

import torch

from . import _build, custom_ops
from .boxes import pairwise_iou
from .matcher import match


class _MatchKernel(_build.Kernel):
    """Shared library and argument checks of K1a and K1b."""

    library = "match_iou"
    source = "aldi_tpu_torch/csrc/match_iou.cu"

    def _check(self, anchors, gt_boxes, gt_valid):
        dev = anchors.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got {dev}")
        if (anchors.dtype != torch.float32 or anchors.dim() != 2
                or anchors.shape[1] != 4 or not anchors.is_contiguous()
                or anchors.data_ptr() % 16):
            raise ValueError("anchors must be a contiguous, 16-byte aligned "
                             "float32 [N, 4]")
        b, m = gt_valid.shape
        if (gt_boxes.device != dev or gt_boxes.dtype != torch.float32
                or gt_boxes.shape != (b, m, 4)
                or not gt_boxes.is_contiguous()):
            raise ValueError("gt_boxes must be a contiguous float32 "
                             "[B, M, 4] on the anchors' device")
        if (gt_valid.device != dev or gt_valid.dtype != torch.bool
                or not gt_valid.is_contiguous()):
            raise ValueError("gt_valid must be a contiguous bool [B, M]")
        cap = self.lib().aldi_match_max_gt()
        if not 1 <= m <= cap:
            raise ValueError(f"{self.name} takes 1..{cap} gt slots, got {m}")
        return b, m


class MatchIou(_MatchKernel):
    """K1a: per anchor the best IoU over valid gt and its first argmax,
    per gt the best IoU over anchors (-1 for invalid columns)."""

    name = "match_iou"
    replaces = "aldi_tpu/ops/pallas_match.py:67"
    argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4)

    def __call__(self, anchors, gt_boxes, gt_valid):
        """anchors [N, 4], gt_boxes [B, M, 4], gt_valid [B, M] on the card
        -> (vals [B, N] f32, idx [B, N] int32, best [B, M] f32)."""
        b, m = self._check(anchors, gt_boxes, gt_valid)
        n = anchors.shape[0]
        dev = anchors.device
        vals = torch.empty((b, n), dtype=torch.float32, device=dev)
        idx = torch.empty((b, n), dtype=torch.int32, device=dev)
        best_bits = torch.zeros((b, m), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            self.launch(
                anchors.data_ptr(), n, gt_boxes.data_ptr(),
                gt_valid.data_ptr(), m, b, vals.data_ptr(), idx.data_ptr(),
                best_bits.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        best = torch.where(gt_valid, best_bits.view(torch.float32),
                           torch.full((), -1.0, device=dev))
        return vals, idx, best


class LowQualityMask(_MatchKernel):
    """K1b: anchors whose IoU equals a valid gt's best IoU (> 0)."""

    name = "low_quality_mask"
    replaces = "aldi_tpu/ops/pallas_match.py:139"
    argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)

    def __call__(self, anchors, gt_boxes, gt_valid, best):
        """As ``MatchIou`` plus best [B, M] from it -> bool [B, N]."""
        b, m = self._check(anchors, gt_boxes, gt_valid)
        if (best.device != anchors.device or best.dtype != torch.float32
                or best.shape != (b, m) or not best.is_contiguous()):
            raise ValueError("best must be a contiguous float32 [B, M]")
        n = anchors.shape[0]
        mask = torch.empty((b, n), dtype=torch.bool, device=anchors.device)
        with torch.cuda.device(anchors.device):
            self.launch(
                anchors.data_ptr(), n, gt_boxes.data_ptr(),
                gt_valid.data_ptr(), best.data_ptr(), m, b, mask.data_ptr(),
                torch.cuda.current_stream(anchors.device).cuda_stream)
        return mask


match_iou = MatchIou()
low_quality_mask = LowQualityMask()


def _masked_iou(anchors, gt_boxes, gt_valid):
    iou = pairwise_iou(anchors, gt_boxes)  # [B, N, M]
    return torch.where(gt_valid[:, None, :], iou,
                       torch.full((), -1.0, device=iou.device))


def match_iou_plain(anchors, gt_boxes, gt_valid):
    """Plain version of K1a, same arguments and results."""
    iou = _masked_iou(anchors, gt_boxes, gt_valid)
    return (iou.amax(dim=-1), iou.argmax(dim=-1).to(torch.int32),
            iou.amax(dim=-2))


def low_quality_mask_plain(anchors, gt_boxes, gt_valid, best):
    """Plain version of K1b, same arguments and result."""
    iou = _masked_iou(anchors, gt_boxes, gt_valid)
    b = best[:, None, :]
    return ((iou == b) & gt_valid[:, None, :] & (b > 0)).any(dim=-1)


def _iou_rn(a, g):
    """``pairwise_iou``'s arithmetic for broadcast anchors a [..., 4] and gt
    g [..., 4], dividing only where the boxes intersect (0 elsewhere, as
    0 / union is): the kernels' ``iou_rn``."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    w = (torch.minimum(a[..., 2], g[..., 2])
         - torch.maximum(a[..., 0], g[..., 0])).clamp(min=0)
    h = (torch.minimum(a[..., 3], g[..., 3])
         - torch.maximum(a[..., 1], g[..., 1])).clamp(min=0)
    inter = w * h
    union = area_a + area_g - inter
    return torch.where((inter > 0) & (union > 0), inter / union,
                       torch.zeros_like(inter))


def candidate_lists(anchors, gt_boxes, keep, block):
    """The kernels' per-block gt culling: anchors cut into blocks of
    ``block`` consecutive anchors (the last one ragged), each block's union
    box, and the slots that pass ``keep`` [B, M] and strictly overlap it,
    as lists in ascending slot order. Returns (blocked anchors [nb, block,
    4], in-range flags [nb, block], list [B, nb, M] (listed slots first),
    list lengths [B, nb])."""
    n = anchors.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    a = torch.cat([anchors, anchors.new_zeros((pad, 4))]).reshape(
        nb, block, 4)
    inside = (torch.arange(nb * block, device=anchors.device) < n).reshape(
        nb, block)
    inf = torch.full((), float("inf"), device=anchors.device)
    lo = torch.where(inside[..., None], a[..., :2], inf).amin(1)  # [nb, 2]
    hi = torch.where(inside[..., None], a[..., 2:], -inf).amax(1)
    g = gt_boxes[:, None]  # [B, 1, M, 4]
    listed = (keep[:, None] & (g[..., 2] > lo[:, None, 0])
              & (g[..., 0] < hi[:, None, 0]) & (g[..., 3] > lo[:, None, 1])
              & (g[..., 1] < hi[:, None, 1]))  # [B, nb, M]
    order = torch.sort((~listed).to(torch.int8), dim=-1, stable=True).indices
    return a, inside, order, listed.sum(-1)


def _listed_entry(gt_boxes, order, count, c):
    """List entry c of every block: (slot [B, nb], its box [B, nb, 4],
    whether the block's list reaches c [B, nb, 1])."""
    slot = order[..., c]
    box = torch.gather(gt_boxes, 1, slot.reshape(slot.shape[0], -1, 1)
                       .expand(-1, -1, 4)).reshape(*slot.shape, 4)
    return slot, box, (c < count)[..., None]


def match_iou_culled(anchors, gt_boxes, gt_valid, block):
    """K1a as the kernel computes it, in plain PyTorch (tests only): per
    block of ``block`` anchors the candidate list (valid slots overlapping
    the block's union box, ascending), each anchor started at (0, first
    valid slot), or (-1, 0) without one, and walked over the list,
    replacing on a strictly greater IoU; per slot the maximum of the
    blocks' maxima over a zero start. Same arguments and results as
    ``match_iou_plain``."""
    b, m = gt_valid.shape
    n = anchors.shape[0]
    a, inside, order, count = candidate_lists(anchors, gt_boxes, gt_valid,
                                              block)
    has_valid = gt_valid.any(-1)[:, None, None]
    first_valid = gt_valid.to(torch.int32).argmax(-1)[:, None, None]
    shape = (b,) + a.shape[:2]
    best = torch.where(has_valid, 0.0, -1.0).expand(shape).clone()
    arg = torch.where(has_valid, first_valid, 0).expand(shape).clone()
    top = torch.zeros((b, m), device=anchors.device)
    for c in range(int(count.max())):
        slot, g, walk = _listed_entry(gt_boxes, order, count, c)
        v = _iou_rn(a[None], g[:, :, None])  # [B, nb, block]
        upd = walk & (v > best)
        best = torch.where(upd, v, best)
        arg = torch.where(upd, slot[..., None].to(arg.dtype), arg)
        block_top = torch.where(walk & inside, v, 0.0).amax(-1)
        top.scatter_reduce_(1, slot, block_top, "amax")
    vals = best.reshape(b, -1)[:, :n]
    idx = arg.reshape(b, -1)[:, :n].to(torch.int32)
    return vals, idx, torch.where(gt_valid, top, -1.0)


def low_quality_mask_culled(anchors, gt_boxes, gt_valid, best, block):
    """K1b as the kernel computes it, in plain PyTorch (tests only): per
    block the list of valid slots with best > 0 that overlap its union box,
    each anchor walked over it until an IoU equals the slot's best. Same
    arguments and result as ``low_quality_mask_plain``."""
    n = anchors.shape[0]
    a, _, order, count = candidate_lists(anchors, gt_boxes,
                                         gt_valid & (best > 0), block)
    hit = torch.zeros((gt_valid.shape[0],) + a.shape[:2], dtype=torch.bool,
                      device=anchors.device)
    for c in range(int(count.max())):
        slot, g, walk = _listed_entry(gt_boxes, order, count, c)
        best_g = torch.gather(best, 1, slot)
        v = _iou_rn(a[None], g[:, :, None])
        hit = hit | (walk & (v == best_g[..., None]))
    return hit.reshape(hit.shape[0], -1)[:, :n]


def match_boxes_plain(anchors, gt_boxes, gt_valid, thresholds, labels,
                      allow_low_quality=False):
    """``pairwise_iou`` followed by ``matcher.match``, batched over images:
    anchors [N, 4], gt_boxes [B, M, 4], gt_valid [B, M] -> (matched_idx
    [B, N] int32, match_labels [B, N] int8)."""
    return match(pairwise_iou(anchors, gt_boxes), gt_valid, thresholds,
                 labels, allow_low_quality)


def match_boxes(anchors, gt_boxes, gt_valid, thresholds, labels,
                allow_low_quality=False):
    """Matcher semantics of ``match_boxes_plain`` for the whole batch,
    through the custom ops ``aldi_tpu_torch::match_iou`` (and
    ``low_quality_mask`` for the low-quality matches): CPU tensors take the
    plain versions, CUDA tensors K1a and K1b."""
    gt_boxes, gt_valid = gt_boxes.contiguous(), gt_valid.contiguous()
    vals, idx, best = custom_ops.match_iou(anchors, gt_boxes, gt_valid)
    out = torch.full(vals.shape, labels[0], dtype=torch.int8,
                     device=vals.device)
    for lo, lab in zip(thresholds, labels[1:]):
        out = torch.where(vals >= lo, torch.full_like(out, lab), out)
    if allow_low_quality:
        lowq = custom_ops.low_quality_mask(anchors, gt_boxes, gt_valid, best)
        out = torch.where(lowq, torch.ones_like(out), out)
    return idx, out
