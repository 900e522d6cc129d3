"""Wrappers of the CUDA ROIAlign kernels: the forward
(``csrc/roi_align_fwd.cu``) and the backward with respect to the features
(``csrc/roi_align_bwd.cu``).

The forward gives each box a warp whose lanes gather 16-byte channel
vectors of the corner rows, all 16 corner loads of a bin in flight before
its sums; the backward owns the gradient tile by tile: a binning pass lists
each level's boxes and flags the 8x8 pixel tiles they can touch, then each
tile's block keeps the boxes that meet it, sums their terms in float32 in
shared memory in a fixed order (no atomics, the same result on every run)
and writes the tile once in the features' dtype (an unflagged tile writes
zeros). Both are bound by the
bytes they move: the forward by the feature rows it reads and the output
it writes, the backward by the dense per-level gradient it writes.

The forward replaces the Pallas forward ``aldi_tpu/ops/pallas_roi_align.py:183``
(``_roi_align_pallas_flat``); the backward replaces the JAX package's XLA
scatter-add backward ``aldi_tpu/ops/roi_align.py:342`` (``_fused_bwd``). The
sources say what bounds them on the card. Their plain PyTorch versions are
``roi_align.roi_align_plain`` and ``roi_align.roi_align_plain_backward``,
which take the same arguments. The libraries are built and loaded on the
first launch, never on import. The wrappers check devices, dtypes, shapes
and contiguity and raise on what the kernels do not take; they never fall
back to the plain versions. The custom ops ``roi_align_fwd`` and
``roi_align_bwd`` of ``custom_ops.py`` call them for CUDA tensors.
"""

import ctypes

import numpy as np
import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class _RoiAlignKernel(_build.Kernel):
    """Shared argument checks and launch of the forward and the backward,
    whose C entry points share their leading arguments."""

    argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                + [ctypes.c_int] * 6)

    def _check(self, hws, dtype, boxes, levels, n_levels, strides):
        b, p = boxes.shape[:2]
        dev = boxes.device
        if dev.type != "cuda":
            raise ValueError(f"{self.name} needs CUDA tensors, got {dev}")
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"{self.name} takes float32 or bfloat16, got "
                             f"{dtype}")
        if (boxes.dtype != torch.float32 or boxes.shape != (b, p, 4)
                or not boxes.is_contiguous()):
            raise ValueError("boxes must be a contiguous float32 [B, P, 4]")
        if (levels.device != dev or levels.dtype != torch.int32
                or levels.shape != (b, p) or not levels.is_contiguous()):
            raise ValueError("levels must be a contiguous int32 [B, P] on the "
                             "boxes' device")
        if n_levels != len(strides) or len(hws) != n_levels:
            raise ValueError("one stride per feature level")

    def _launch(self, ptrs, hws, strides, boxes, levels, c, output_size,
                sampling_ratio, dtype, *data):
        """``data``: the entry point's arguments after the dtype, but for
        the stream."""
        b, p = boxes.shape[:2]
        ptrs = np.asarray(ptrs, np.uint64)
        hw = np.asarray(hws, np.int32)
        scale = np.asarray([1.0 / s for s in strides], np.float32)
        dev = boxes.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            self.launch(ptrs.ctypes.data, hw.ctypes.data, scale.ctypes.data,
                        len(hws), boxes.data_ptr(), levels.data_ptr(), p,
                        b * p, c, output_size, sampling_ratio,
                        _DTYPE_CODES[dtype], *data, stream)


class RoiAlignFwd(_RoiAlignKernel):
    """K2 forward: multi-level ROIAlign of NHWC levels."""

    name = library = "roi_align_fwd"
    argtypes = _RoiAlignKernel.argtypes + [ctypes.c_void_p] * 2
    source = "aldi_tpu_torch/csrc/roi_align_fwd.cu"
    replaces = "aldi_tpu/ops/pallas_roi_align.py:183"

    def __call__(self, features, boxes, levels, strides, output_size=7,
                 sampling_ratio=2):
        """features: per-level [B, H_l, W_l, C] contiguous CUDA tensors of
        one dtype (float32 or bfloat16); boxes [B, P, 4] float32; levels
        [B, P] int32 (-1 = invalid). Returns [B, P, out, out, C]."""
        b, p = boxes.shape[:2]
        c = features[0].shape[-1]
        dtype = features[0].dtype
        hws = [(int(f.shape[1]), int(f.shape[2])) for f in features]
        self._check(hws, dtype, boxes, levels, len(features), strides)
        for f in features:
            if (f.device != boxes.device or f.dtype != dtype or f.dim() != 4
                    or f.shape[0] != b or f.shape[-1] != c
                    or not f.is_contiguous()):
                raise ValueError(
                    "features must be contiguous [B, H, W, C] tensors of one "
                    "dtype on the boxes' device")
        out = torch.empty((b, p, output_size, output_size, c), dtype=dtype,
                          device=boxes.device)
        if b * p == 0:
            return out
        self._launch([f.data_ptr() for f in features], hws, strides, boxes,
                     levels, c, output_size, sampling_ratio, dtype,
                     out.data_ptr())
        return out


class RoiAlignBwd(_RoiAlignKernel):
    """K2 backward: d(features) of ``RoiAlignFwd`` for a cotangent."""

    name = library = "roi_align_bwd"
    argtypes = (_RoiAlignKernel.argtypes
                + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2)
    source = "aldi_tpu_torch/csrc/roi_align_bwd.cu"
    replaces = "aldi_tpu/ops/roi_align.py:342"

    def __call__(self, grad, boxes, levels, feat_shapes, feat_dtype, strides,
                 sampling_ratio=2):
        """grad [B, P, out, out, C] (float32 or bfloat16) on the card; boxes
        and levels as for the forward; feat_shapes the per-level (H_l, W_l).
        Returns per-level [B, H_l, W_l, C] gradients in ``feat_dtype``,
        summed in float32 and written once by the kernel: no float32 table
        of the levels is allocated, zeroed or cast."""
        b, p, output_size, _, c = grad.shape
        self._check(feat_shapes, grad.dtype, boxes, levels,
                    len(feat_shapes), strides)
        if feat_dtype not in _DTYPE_CODES:
            raise ValueError(f"roi_align_bwd returns float32 or bfloat16, "
                             f"got {feat_dtype}")
        if grad.device != boxes.device or not grad.is_contiguous():
            raise ValueError("grad must be contiguous on the boxes' device")
        if b * p == 0:
            return [torch.zeros((b, h, w, c), dtype=feat_dtype,
                                device=boxes.device) for h, w in feat_shapes]
        outs = [torch.empty((b, h, w, c), dtype=feat_dtype,
                            device=boxes.device) for h, w in feat_shapes]
        size = self.lib().aldi_roi_align_bwd_scratch_bytes
        size.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
        size.restype = ctypes.c_longlong
        hw = np.asarray(feat_shapes, np.int32)
        n_bytes = size(hw.ctypes.data, len(feat_shapes), b * p, p)
        if n_bytes < 0:
            raise ValueError(f"roi_align_bwd: bad level shapes {feat_shapes}")
        # the per-level box lists and the tile flags of the binning pass
        scratch = torch.empty(n_bytes, dtype=torch.uint8, device=boxes.device)
        self._launch([t.data_ptr() for t in outs], feat_shapes, strides,
                     boxes, levels, c, output_size, sampling_ratio,
                     grad.dtype, grad.data_ptr(), _DTYPE_CODES[feat_dtype],
                     scratch.data_ptr())
        return outs


roi_align_fwd = RoiAlignFwd()
roi_align_bwd = RoiAlignBwd()
