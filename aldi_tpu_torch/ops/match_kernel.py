"""Anchor <-> ground-truth matching: the CUDA kernels K1a/K1b
(``csrc/match_iou.cu``), their plain PyTorch versions, and ``match_boxes``.

Counterpart of ``aldi_tpu/ops/pallas_match.py``: ``match_iou`` replaces
``match_iou_pallas`` (``:67``) and ``low_quality_mask`` replaces
``low_quality_mask_pallas`` (``:139``); the source says what bounds them on
the card. Unlike the Pallas kernels, one launch covers every image of the
batch. ``match_boxes`` sends CPU tensors to ``match_boxes_plain``
(``pairwise_iou`` + ``matcher.match``) and CUDA tensors to the kernels; it
never falls back. The libraries are built on the first launch, never on
import.
"""

import ctypes

import torch

from . import _build
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


def match_boxes_plain(anchors, gt_boxes, gt_valid, thresholds, labels,
                      allow_low_quality=False):
    """``pairwise_iou`` followed by ``matcher.match``, batched over images:
    anchors [N, 4], gt_boxes [B, M, 4], gt_valid [B, M] -> (matched_idx
    [B, N] int32, match_labels [B, N] int8)."""
    return match(pairwise_iou(anchors, gt_boxes), gt_valid, thresholds,
                 labels, allow_low_quality)


def match_boxes(anchors, gt_boxes, gt_valid, thresholds, labels,
                allow_low_quality=False):
    """Matcher semantics of ``match_boxes_plain`` for the whole batch: CPU
    tensors take the plain version, CUDA tensors K1a (and K1b for the
    low-quality matches)."""
    if anchors.device.type == "cpu":
        return match_boxes_plain(anchors, gt_boxes, gt_valid, thresholds,
                                 labels, allow_low_quality)
    gt_boxes, gt_valid = gt_boxes.contiguous(), gt_valid.contiguous()
    vals, idx, best = match_iou(anchors, gt_boxes, gt_valid)
    out = torch.full(vals.shape, labels[0], dtype=torch.int8,
                     device=vals.device)
    for lo, lab in zip(thresholds, labels[1:]):
        out = torch.where(vals >= lo, torch.full_like(out, lab), out)
    if allow_low_quality:
        lowq = low_quality_mask(anchors, gt_boxes, gt_valid, best)
        out = torch.where(lowq, torch.ones_like(out), out)
    return idx, out
