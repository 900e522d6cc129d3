"""Wrappers of the conv epilogue kernels (``csrc/conv_epilogue.cu``): the
forward, in place on a conv's output, and its backward.

The forward takes a conv's output y ([N, C, H, W] in ``channels_last``
memory, float32 or bfloat16) and a float32 bias [C] and writes in place,
computed in float32 and rounded once, one of four forms: y + bias, its
ReLU, relu(y + bias + residual) (the residual of y's shape), or y + bias +
coarse (a coarse map [N, C, H/2, W/2], added at (h/2, w/2)). The backward takes the gradient of
that output (and the output itself where the forward had a ReLU) and
returns the masked gradient, the float32 bias gradient and the coarse
map's gradient, each only where asked. No TPU kernel is replaced: XLA
fuses a conv with what follows it. The plain PyTorch versions are
``conv_epilogue.conv_epilogue_plain`` and
``conv_epilogue.conv_epilogue_plain_backward``; the ops ``conv_epilogue``
and ``conv_epilogue_bwd`` of ``custom_ops.py`` call these wrappers for CUDA
tensors. The wrappers check devices, dtypes, shapes and layouts and raise
on what the kernels do not take; they never fall back. Each launch's host
path is a few attribute tests and one ctypes call (``_build.Kernel``
resolves the entry point once), since an R50-FPN request makes 72 of them.
"""

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CL = torch.channels_last
# the blocks of a backward with a bias gradient, each summing its rows into
# one float32 row of scratch; a second launch sums those rows in order
PARTIAL_ROWS = 528


def _nhwc(t, what, like=None, shape=None):
    """Raise unless ``t`` is a CUDA tensor in ``channels_last`` memory of a
    kernel dtype (``like``'s device and dtype, and ``shape``, if given)."""
    if like is None:
        ok = t.is_cuda and t.dtype in _DTYPE_CODES and t.dim() == 4
    else:
        ok = t.get_device() == like.get_device() and t.dtype == like.dtype
    if not (ok and t.is_contiguous(memory_format=_CL)
            and (shape is None or t.shape == shape)):
        raise ValueError(
            f"conv_epilogue: {what} must be a CUDA float32 or bfloat16 "
            f"[N, C, H, W] in channels_last memory"
            + ("" if like is None else " of y's device and dtype")
            + ("" if shape is None else f", shape {tuple(shape)}")
            + f"; got {t.dtype} {tuple(t.shape)} strides {t.stride()} on "
            f"{t.device}")


def _launch(kernel, t, *args):
    """Launch on the current stream of ``t``'s device, that device being
    the current one while the entry point runs."""
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        kernel.launch(*args, torch._C._cuda_getCurrentRawStream(index))
        return
    with torch.cuda.device(index):
        kernel.launch(*args, torch._C._cuda_getCurrentRawStream(index))


class ConvEpilogue(_build.Kernel):
    """The forward: y <- y + bias (+ residual) (+ up2(coarse)), ReLU if
    asked, in place."""

    name = library = "conv_epilogue"
    source = "aldi_tpu_torch/csrc/conv_epilogue.cu"
    replaces = None  # XLA's fusion of a conv and its pointwise tail
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def __call__(self, y, bias, residual=None, coarse=None, relu=False):
        if ((residual is not None and (coarse is not None or not relu))
                or (coarse is not None and relu)):
            raise ValueError("conv_epilogue takes bias, bias + ReLU, bias + "
                             "residual + ReLU or bias + coarse")
        _nhwc(y, "y")
        n, c, h, w = y.shape
        if (bias.get_device() != y.get_device()
                or bias.dtype != torch.float32 or bias.shape != (c,)
                or not bias.is_contiguous()):
            raise ValueError("conv_epilogue: bias must be a contiguous "
                             f"float32 [{c}] on y's device")
        r = m = None
        if residual is not None:
            _nhwc(residual, "residual", y, y.shape)
            r = residual.data_ptr()
        if coarse is not None:
            if h % 2 or w % 2:
                raise ValueError("conv_epilogue: a coarse map needs an even "
                                 f"height and width, got {h} x {w}")
            _nhwc(coarse, "coarse", y, (n, c, h // 2, w // 2))
            m = coarse.data_ptr()
        _launch(self, y, y.data_ptr(), bias.data_ptr(), r, m, n * h * w, h,
                w, c, int(relu), _DTYPE_CODES[y.dtype])


class ConvEpilogueBwd(_build.Kernel):
    """The backward: (masked gradient, bias gradient, coarse gradient)."""

    name = "conv_epilogue_bwd"
    library = "conv_epilogue"
    source = "aldi_tpu_torch/csrc/conv_epilogue.cu"
    replaces = None
    argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def __call__(self, grad, out, bias_grad, coarse_grad):
        """grad [N, C, H, W] in channels_last memory; out (the forward's
        output, where it had a ReLU) or None. Returns (grad zeroed where
        out <= 0, or an empty tensor without ``out``; the float32 bias
        gradient [C], or empty; the coarse map's gradient [N, C, H/2,
        W/2] in channels_last memory, or empty)."""
        _nhwc(grad, "grad")
        n, c, h, w = grad.shape
        if out is None and not (bias_grad or coarse_grad):
            raise ValueError("conv_epilogue_bwd: nothing to compute")
        if out is not None and coarse_grad:
            raise ValueError("conv_epilogue_bwd: no forward form has both a "
                             "ReLU and a coarse map")
        empty = grad.new_empty(0)
        gy = gb = gm = partial = None
        if out is not None:
            _nhwc(out, "out", grad, grad.shape)
            gy = torch.empty_like(grad, memory_format=_CL)
        if bias_grad:
            # the bias gradient, then the partial rows summed into it
            flat = torch.empty((PARTIAL_ROWS + 1) * c, dtype=torch.float32,
                               device=grad.device)
            gb, partial = flat[:c], flat[c:]
        if coarse_grad:
            if h % 2 or w % 2:
                raise ValueError("conv_epilogue_bwd: a coarse map needs an "
                                 f"even height and width, got {h} x {w}")
            gm = torch.empty((n, c, h // 2, w // 2), dtype=grad.dtype,
                             device=grad.device, memory_format=_CL)
        ptr = (lambda t: None if t is None else t.data_ptr())
        _launch(self, grad, grad.data_ptr(), ptr(out), ptr(gy),
                ptr(gb), ptr(gm), ptr(partial), PARTIAL_ROWS, n * h * w, h,
                w, c, _DTYPE_CODES[grad.dtype])
        return (empty if gy is None else gy,
                grad.new_empty(0, dtype=torch.float32) if gb is None else gb,
                empty if gm is None else gm)


conv_epilogue = ConvEpilogue()
conv_epilogue_bwd = ConvEpilogueBwd()
