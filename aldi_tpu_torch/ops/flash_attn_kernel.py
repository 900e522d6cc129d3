"""Wrappers of the CUDA rel-pos attention kernels: the forward
(``csrc/flash_attn_fwd.cu``, K3a) and the backward (``csrc/flash_attn_bwd.cu``,
K3b).

They replace the Pallas kernels of ``aldi_tpu/ops/pallas_flash_attn.py``:
the forward ``_attn_fwd`` (``:222``) and the backward ``_attn_bwd``
(``:262``). The sources say what bounds them on the card. Their plain
PyTorch versions are ``flash_attn.flash_attn_plain`` and
``flash_attn.flash_attn_plain_backward``, which take the same arguments.
The libraries are built and loaded on the first launch, never on import.
The wrappers check devices, dtypes, shapes and contiguity and raise on what
the kernels do not take; they never fall back to the plain versions. The
custom ops ``flash_attn_fwd`` and ``flash_attn_bwd`` of ``custom_ops.py``
call them for CUDA tensors.
"""

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
MAX_SMEM_BYTES = 232448  # what one block may use on Hopper (227 KB)


def _check(name, q, k, v, bh, bw, h_grid, w_grid):
    if q.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    g, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"{name} takes head dim {HEAD_DIM} only, got {d}")
    if h_grid * w_grid != n:
        raise ValueError(f"{name}: N={n} is not h_grid*w_grid="
                         f"{h_grid}*{w_grid}")
    for t, what in ((k, "k"), (v, "v")):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} must have q's shape and dtype")
    for t, what, c in ((bh, "bh", h_grid), (bw, "bw", w_grid)):
        if t.shape != (g, n, c) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32 [G, N, {c}]")
    for t in (q, k, v, bh, bw):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one "
                             "device")


def _check_smem(kernel, dtype, h_grid, w_grid):
    """Raise, naming the grid, when a block of the kernel would need more
    shared memory than the card has (the bias rows of a wide grid)."""
    query = getattr(kernel.lib(), f"aldi_{kernel.name}_smem")
    query.argtypes = [ctypes.c_int] * 3
    smem = query(h_grid, w_grid, _DTYPE_CODES[dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{kernel.name}: a {h_grid}x{w_grid} grid needs "
                         f"{smem} bytes of shared memory per block, more "
                         f"than the card's {MAX_SMEM_BYTES}")


class FlashAttnFwd(_build.Kernel):
    """K3a: out [G, N, 64] (q's dtype) and lse [G, N] (float32)."""

    name = library = "flash_attn_fwd"
    source = "aldi_tpu_torch/csrc/flash_attn_fwd.cu"
    replaces = "aldi_tpu/ops/pallas_flash_attn.py:222"
    argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q, k, v, bh, bw, scale, h_grid, w_grid):
        _check(self.name, q, k, v, bh, bw, h_grid, w_grid)
        _check_smem(self, q.dtype, h_grid, w_grid)
        g, n, _ = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((g, n), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            self.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bh.data_ptr(), bw.data_ptr(), out.data_ptr(),
                        lse.data_ptr(), g, n, h_grid, w_grid,
                        _DTYPE_CODES[q.dtype], float(scale), stream)
        return out, lse


class FlashAttnBwd(_build.Kernel):
    """K3b: (dq, dk, dv) in q's dtype and (dbh, dbw) in float32, from the
    forward's lse and delta = rowsum(dout * out)."""

    name = library = "flash_attn_bwd"
    source = "aldi_tpu_torch/csrc/flash_attn_bwd.cu"
    replaces = "aldi_tpu/ops/pallas_flash_attn.py:262"
    argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_void_p])

    def __call__(self, q, k, v, bh, bw, lse, delta, dout, scale, h_grid,
                 w_grid):
        _check(self.name, q, k, v, bh, bw, h_grid, w_grid)
        g, n, _ = q.shape
        if dout.shape != q.shape or dout.dtype != q.dtype:
            raise ValueError(f"{self.name}: dout must have q's shape and "
                             "dtype")
        for t, what in ((lse, "lse"), (delta, "delta")):
            if t.shape != (g, n) or t.dtype != torch.float32:
                raise ValueError(f"{self.name}: {what} must be float32 "
                                 "[G, N]")
        for t in (dout, lse, delta):
            if t.device != q.device or not t.is_contiguous():
                raise ValueError(f"{self.name}: inputs must be contiguous on "
                                 "one device")
        _check_smem(self, q.dtype, h_grid, w_grid)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        dbh = torch.empty((g, n, h_grid), dtype=torch.float32,
                          device=q.device)
        dbw = torch.empty((g, n, w_grid), dtype=torch.float32,
                          device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            self.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        bh.data_ptr(), bw.data_ptr(), dout.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), dbh.data_ptr(),
                        dbw.data_ptr(), g, n, h_grid, w_grid,
                        _DTYPE_CODES[q.dtype], float(scale), stream)
        return dq, dk, dv, dbh, dbw


flash_attn_fwd = FlashAttnFwd()
flash_attn_bwd = FlashAttnBwd()
