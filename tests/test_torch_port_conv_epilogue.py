"""The conv epilogue op (``aldi_tpu_torch/ops/conv_epilogue.py``) on the
CPU: its plain version equals the op sequence it replaces, its gradient
passes ``gradcheck`` in float64, its custom ops pass ``opcheck``, and the
R50-FPN trunk and RPN head on the CPU, which never take the kernel, keep
every bit of the separate ops they ran before.

The card's tests of the kernel are in ``test_torch_port_cuda.py``. This
file imports neither JAX nor the JAX package.
"""

import pytest
import torch
import torch.nn.functional as F

from aldi_tpu_torch.ops import conv_epilogue as ce
from aldi_tpu_torch.ops import custom_ops
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

CL = torch.channels_last
FORMS = ("bias", "bias_relu", "residual_relu", "top_down")


def _nhwc(gen, shape, dtype):
    return torch.randn(shape, generator=gen).to(dtype).contiguous(
        memory_format=CL)


def _form_args(form, dtype, seed=0, n=2, c=12, h=6, w=10):
    """(y, bias, residual, coarse, relu) of ``form``; the bias float32."""
    gen = torch.Generator().manual_seed(seed)
    y = _nhwc(gen, (n, c, h, w), dtype)
    bias = torch.randn(c, generator=gen)
    residual = (_nhwc(gen, (n, c, h, w), dtype) if form == "residual_relu"
                else None)
    coarse = (_nhwc(gen, (n, c, h // 2, w // 2), dtype) if form == "top_down"
              else None)
    return y, bias, residual, coarse, form in ("bias_relu", "residual_relu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", FORMS)
def test_plain_op_equals_the_op_sequence(form, dtype):
    """On CPU tensors the op writes, in place, what the models' separate
    ops gave: the bias cast to y's dtype and added, the residual or the
    nearest-2x top-down add, the ReLU; bit for bit."""
    y, bias, residual, coarse, relu = _form_args(form, dtype)
    want = y + bias.to(dtype)[:, None, None]
    if residual is not None:
        want = want + residual
    if coarse is not None:
        want = want + F.interpolate(coarse, scale_factor=2, mode="nearest")
    if relu:
        want = F.relu(want)
    ptr = y.data_ptr()
    got = ce.conv_epilogue(y, bias, residual, coarse, relu)
    assert got.data_ptr() == ptr and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_gradient_passes_gradcheck(form):
    """``ConvEpilogueFunction`` in float64 against finite differences, with
    every input requiring a gradient (the forward writes into a copy of
    y, as a conv's fresh output would be)."""
    y, bias, residual, coarse, relu = _form_args(form, torch.float64, c=5,
                                                 h=4, w=6)
    bias = bias.double()
    inputs = [t.requires_grad_() if t is not None else None
              for t in (y, bias, residual, coarse)]

    def fn(y, bias, residual, coarse):
        return ce.conv_epilogue(y.clone(), bias, residual, coarse, relu)

    assert torch.autograd.gradcheck(fn, tuple(inputs))


@pytest.mark.parametrize("name", ["conv_epilogue", "conv_epilogue_bwd"])
def test_epilogue_ops_pass_opcheck(name):
    """``torch.library.opcheck`` of the two ops on CPU tensors (schema with
    the forward's mutation of y, fake implementations, AOT dispatch)."""
    y, bias, residual, coarse, _ = _form_args("top_down", torch.float32)
    if name == "conv_epilogue":
        args = (y, bias, residual, coarse, True)
    else:
        args = (y, F.relu(y), True, True)
    result = torch.library.opcheck(getattr(custom_ops, name), args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_takes_no_cpu_tensor():
    y = torch.zeros((1, 8, 2, 2)).contiguous(memory_format=CL)
    assert not ce.takes(y)
    assert not ce.takes(y, y)


def _todays_trunk_and_rpn(module, x):
    """The R50-FPN trunk and RPN head as separate ops, as the port ran them
    before the epilogue: every conv with its bias, then the ReLU, the
    residual add and the top-down add each on its own."""
    def frozen(x, conv, stride, padding):
        scale, shift = conv.norm.scale_shift()
        dt = conv.compute_dtype
        w = (conv.weight.float() * scale[:, None, None, None]).to(dt)
        return F.conv2d(x.to(dt), w, shift.to(dt), stride, padding)

    fpn = module.backbone
    res = fpn.bottom_up
    out = F.max_pool2d(F.relu(frozen(x, res.stem.conv1, 2, 3)), 3, 2,
                       padding=1)
    feats = []
    for name in res.stage_names:
        for blk in getattr(res, name):
            o = F.relu(frozen(out, blk.conv1, blk.conv1.stride, 0))
            o = F.relu(frozen(o, blk.conv2, blk.conv2.stride, 1))
            o = frozen(o, blk.conv3, 1, 0)
            sc = (out if blk.shortcut is None
                  else frozen(out, blk.shortcut, blk.shortcut.stride, 0))
            out = F.relu(o + sc)
        feats.append(out)

    def conv(layer, t):
        dt = layer.compute_dtype
        return F.conv2d(t.to(dt), layer.weight.to(dt), layer.bias.to(dt),
                        layer.stride, layer.padding)

    merged = conv(fpn.fpn_lateral5, feats[-1])
    levels = [conv(fpn.fpn_output5, merged)]
    for i in range(2, -1, -1):
        merged = conv(getattr(fpn, f"fpn_lateral{i + 2}"), feats[i]) + \
            F.interpolate(merged, scale_factor=2, mode="nearest")
        levels.insert(0, conv(getattr(fpn, f"fpn_output{i + 2}"), merged))
    levels.append(F.max_pool2d(levels[-1], kernel_size=1, stride=2))
    head = module.proposal_generator["rpn_head"]
    logits, deltas = [], []
    for f in levels:
        t = F.relu(conv(head.conv, f))
        logits.append(conv(head.objectness_logits, t))
        deltas.append(conv(head.anchor_deltas, t))
    return levels, logits, deltas


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r50fpn_on_the_cpu_keeps_the_separate_ops(dtype, monkeypatch):
    """A ResNet-50-FPN trunk and its RPN head on the CPU (canvas 64, seeded
    weights with FrozenBN statistics away from the identity): bit-identical
    to the separate ops, and the epilogue op is never called."""
    from aldi_tpu_torch.config import get_cfg
    from aldi_tpu_torch.models import build_detector

    cfg = get_cfg()
    cfg.TPU.CANVAS = (64, 64)
    cfg.TPU.COMPUTE_DTYPE = dtype
    det = build_detector(cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    state = {}
    for k, v in det.module.state_dict().items():
        if k.endswith(("running_var", "norm.weight")):
            state[k] = torch.rand(v.shape, generator=gen) + 0.5
        elif v.dim() == 4:
            fan = v[0].numel()
            state[k] = torch.randn(v.shape, generator=gen) / fan ** 0.5
        else:
            state[k] = torch.randn(v.shape, generator=gen) * 0.1
    det.module.load_state_dict(state)
    images = torch.rand((2, 64, 64, 3), generator=gen) * 255

    def never(*args):
        raise AssertionError("the epilogue op ran on the CPU")

    monkeypatch.setattr(custom_ops, "conv_epilogue", never)
    with torch.no_grad():
        x = det.preprocess(images)
        feats = det.backbone(x)
        logits, deltas = det.rpn_head(feats)
        levels, want_logits, want_deltas = _todays_trunk_and_rpn(
            det.module, x.permute(0, 3, 1, 2))
    for got, want in zip(feats, levels):
        assert torch.equal(got, want.permute(0, 2, 3, 1))
    for got, want in zip(logits, want_logits):
        assert torch.equal(got, want.permute(0, 2, 3, 1).reshape(2, -1))
    for got, want in zip(deltas, want_deltas):
        assert torch.equal(got, want.permute(0, 2, 3, 1).reshape(2, -1, 4))
