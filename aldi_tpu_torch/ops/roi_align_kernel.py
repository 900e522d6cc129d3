"""Wrapper of the CUDA ROIAlign forward kernel (``csrc/roi_align_fwd.cu``).

The kernel replaces the Pallas forward ``aldi_tpu/ops/pallas_roi_align.py:183``
(``_roi_align_pallas_flat``); the source says what bounds it on the card.
Its plain PyTorch version is ``roi_align.roi_align_plain``, which takes the
same arguments. The library is built and loaded on the first launch, never
on import. The wrapper checks devices, dtypes, shapes and contiguity and
raises on what the kernel does not take; it never falls back to the plain
version.
"""

import ctypes

import numpy as np
import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class RoiAlignFwd:
    """Callable kernel wrapper; ``launches`` counts kernel launches."""

    name = "roi_align_fwd"
    source = "aldi_tpu_torch/csrc/roi_align_fwd.cu"
    replaces = "aldi_tpu/ops/pallas_roi_align.py:183"

    def __init__(self):
        self.launches = 0
        self._fn = None
        self._err = None

    def _load(self):
        if self._fn is None:
            lib = _build.load(self.name)
            fn = lib.aldi_roi_align_fwd
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
                [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + \
                [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            err = lib.aldi_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def __call__(self, features, boxes, levels, strides, output_size=7,
                 sampling_ratio=2):
        """features: per-level [B, H_l, W_l, C] contiguous CUDA tensors of
        one dtype (float32 or bfloat16); boxes [B, P, 4] float32; levels
        [B, P] int32 (-1 = invalid). Returns [B, P, out, out, C]."""
        b, p = boxes.shape[:2]
        c = features[0].shape[-1]
        dtype = features[0].dtype
        dev = boxes.device
        if dev.type != "cuda":
            raise ValueError(f"roi_align_fwd needs CUDA tensors, got {dev}")
        if dtype not in _DTYPE_CODES:
            raise ValueError(f"roi_align_fwd takes float32 or bfloat16, "
                             f"got {dtype}")
        for f in features:
            if (f.device != dev or f.dtype != dtype or f.dim() != 4
                    or f.shape[0] != b or f.shape[-1] != c
                    or not f.is_contiguous()):
                raise ValueError(
                    "features must be contiguous [B, H, W, C] tensors of one "
                    "dtype on the boxes' device")
        if (boxes.dtype != torch.float32 or boxes.shape != (b, p, 4)
                or not boxes.is_contiguous()):
            raise ValueError("boxes must be a contiguous float32 [B, P, 4]")
        if (levels.device != dev or levels.dtype != torch.int32
                or levels.shape != (b, p) or not levels.is_contiguous()):
            raise ValueError("levels must be a contiguous int32 [B, P] on the "
                             "boxes' device")
        if len(features) != len(strides):
            raise ValueError("one stride per feature level")

        out = torch.empty((b, p, output_size, output_size, c), dtype=dtype,
                          device=dev)
        if b * p == 0:
            return out
        ptrs = np.asarray([f.data_ptr() for f in features], np.uint64)
        hw = np.asarray([[f.shape[1], f.shape[2]] for f in features],
                        np.int32)
        scale = np.asarray([1.0 / s for s in strides], np.float32)
        fn = self._load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(ptrs.ctypes.data, hw.ctypes.data, scale.ctypes.data,
                    len(features), boxes.data_ptr(), levels.data_ptr(), p,
                    b * p, c, output_size, sampling_ratio,
                    _DTYPE_CODES[dtype], out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"roi_align_fwd launch failed: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1
        return out


roi_align_fwd = RoiAlignFwd()
