"""The pointwise work after a convolution as one op: the bias, a residual
or the FPN's nearest-2x top-down add, and a ReLU.

``conv_epilogue(y, bias, residual, coarse, relu)`` takes a bias-free
conv's output y and returns, in y's memory,

    y + bias (+ residual) (+ upsample_nearest_2x(coarse)), then ReLU if asked

in the forms the R-CNN trunks and heads use: the bias alone (FPN outputs,
the top FPN lateral), bias + ReLU (the ResNet stem, a bottleneck's first
two convs, the RPN head's conv), bias + residual + ReLU (a bottleneck's
last conv; with a projection shortcut the residual is the shortcut conv's
bias-free output and the two FrozenBN shifts are summed into the bias) and
bias + top-down add (the FPN laterals below the top). It is the op
``aldi_tpu_torch::conv_epilogue`` (``custom_ops.py``): CPU tensors run
``conv_epilogue_plain``, the op sequence the models ran before, and CUDA
tensors the kernel ``csrc/conv_epilogue.cu`` (``conv_epilogue_kernel.py``),
which computes in float32 and rounds once. Its gradient is
``ConvEpilogueFunction``, whose backward is the op ``conv_epilogue_bwd``.

The models call it only where ``takes`` holds: a CUDA input, float32 or
bfloat16. Everything else, the CPU above all, runs the conv with its bias
and the separate ops as before, so the CPU's outputs keep every bit.
"""

import torch
import torch.nn.functional as F

from . import custom_ops

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def takes(*tensors) -> bool:
    """Whether a conv of ``tensors[0]`` ends in the epilogue kernel, with
    the others as its residual or coarse map: all CUDA tensors of one
    float32 or bfloat16 dtype. The kernel takes its operands in
    ``channels_last`` memory, as every trunk gets them (the detectors permute
    NHWC images), and raises on another layout."""
    dtype = tensors[0].dtype
    return dtype in _KERNEL_DTYPES and all(
        t.is_cuda and t.dtype == dtype for t in tensors)


def conv_epilogue_plain(y, bias, residual=None, coarse=None, relu=False):
    """The op sequence the kernel replaces, in y's dtype: the bias cast to
    it and added, then the residual, then the nearest-2x upsampling of
    ``coarse``, then the ReLU."""
    out = y + bias.to(y.dtype)[:, None, None]
    if residual is not None:
        out = out + residual
    if coarse is not None:
        out = out + F.interpolate(coarse, scale_factor=2, mode="nearest")
    return F.relu(out) if relu else out


def conv_epilogue_plain_backward(grad, out, bias_grad, coarse_grad):
    """The gradients of ``conv_epilogue_plain`` for ``grad`` of its output:
    (grad zeroed where ``out`` <= 0, ReLU's backward, or an empty tensor
    where ``out`` is None; the bias gradient summed in at least float32,
    or empty; the coarse map's gradient, the 2x2 sums in ``channels_last``
    memory, or empty)."""
    gy = grad if out is None else torch.ops.aten.threshold_backward(
        grad, out, 0)
    acc = torch.promote_types(grad.dtype, torch.float32)
    gb = (gy.sum((0, 2, 3), dtype=acc) if bias_grad
          else grad.new_empty(0, dtype=acc))
    gm = grad.new_empty(0)
    if coarse_grad:
        n, c, h, w = gy.shape
        gm = gy.to(acc).reshape(n, c, h // 2, 2, w // 2, 2).sum(
            (3, 5)).to(grad.dtype).contiguous(
                memory_format=torch.channels_last)
    return (grad.new_empty(0) if out is None else gy), gb, gm


class ConvEpilogueFunction(torch.autograd.Function):
    """``conv_epilogue`` with its gradient: the op's backward writes the
    one gradient that the conv's output and the residual share, the bias
    gradient where the bias is a parameter (FrozenBN shifts are buffers
    and get none) and the coarse map's, in one pass."""

    @staticmethod
    def forward(ctx, y, bias, residual, coarse, relu):
        custom_ops.conv_epilogue(y, bias, residual, coarse, relu)
        ctx.mark_dirty(y)
        ctx.save_for_backward(y if relu else None)
        return y

    @staticmethod
    def backward(ctx, grad):
        (out,) = ctx.saved_tensors
        _, bias_grad, res_grad, coarse_grad, _ = ctx.needs_input_grad
        gy, gb, gm = grad, None, None
        if out is not None or bias_grad or coarse_grad:
            if grad.is_cuda:
                grad = grad.contiguous(memory_format=torch.channels_last)
            masked, gb, gm = custom_ops.conv_epilogue_bwd(
                grad, out, bias_grad, coarse_grad)
            gy = grad if out is None else masked
        return (gy, gb if bias_grad else None, gy if res_grad else None,
                gm if coarse_grad else None, None)


def conv_epilogue(y, bias, residual=None, coarse=None, relu=False):
    """y + bias (+ residual) (+ nearest-2x ``coarse``), ReLU if ``relu``,
    written into y and returned (see the module docstring). Goes through
    ``ConvEpilogueFunction`` only where a gradient is wanted."""
    if torch.is_grad_enabled() and (
            y.requires_grad or bias.requires_grad
            or (residual is not None and residual.requires_grad)
            or (coarse is not None and coarse.requires_grad)):
        return ConvEpilogueFunction.apply(y, bias, residual, coarse, relu)
    custom_ops.conv_epilogue(y, bias, residual, coarse, relu)
    return y
