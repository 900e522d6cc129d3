"""The precision of the reference's products.

Every convolution, linear layer and attention product of the reference
goes through ``conv2d``, ``linear`` or ``matmul`` here. By default they run
in float32 with TF32 off (``strict_float32``). Inside ``products("fp8")``
they run as fp8 training runs its GEMMs, with float32 accumulation: both
operands of the forward product rounded to float8 e4m3, and the gradient
arriving at its output rounded to float8 e5m2 before the two products of
its backward, each with one scale per tensor (its largest magnitude mapped
to the format's largest finite value). That is the control which the
benchmark's comparison has to reject, one precision below the
configurations' bfloat16.
"""

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
_mode = ["float32"]


def strict_float32() -> None:
    """No TF32 in matrix products or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def products(mode: str):
    """Run the reference's products in ``mode`` ("float32" or "fp8")."""
    if mode not in ("float32", "fp8"):
        raise ValueError(f"unknown product precision {mode!r}")
    saved = _mode[0]
    _mode[0] = mode
    try:
        yield
    finally:
        _mode[0] = saved


def _quantize(x, dtype, largest):
    """``x`` in float32 rounded to ``dtype`` under a per-tensor scale."""
    xf = x.float()
    scale = largest / xf.abs().amax().clamp(min=1e-30)
    return (xf * scale).to(dtype).to(torch.float32) / scale


def _round(x: torch.Tensor) -> torch.Tensor:
    """A forward operand rounded to e4m3; its gradient passes straight
    through, as the rounding's is taken."""
    if _mode[0] == "float32":
        return x
    xf = x.float()
    return xf + (_quantize(xf.detach(), torch.float8_e4m3fn, E4M3_MAX)
                 - xf).detach()


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, torch.float8_e5m2, E5M2_MAX)


def _out(y: torch.Tensor) -> torch.Tensor:
    if _mode[0] == "float32" or not y.requires_grad:
        return y
    return _GradE5M2.apply(y)


def conv2d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    return _out(F.conv2d(_round(x), _round(w), b, stride, padding, dilation,
                         groups))


def linear(x, w, b=None):
    return _out(F.linear(_round(x), _round(w), b))


def matmul(a, b):
    return _out(torch.matmul(_round(a), _round(b)))


def conv_transpose2d(x, w, b=None, stride=1):
    return _out(F.conv_transpose2d(_round(x), _round(w), b, stride=stride))
