"""Port parity of the ops: boxes, anchors, NMS and ROIAlign
(``aldi_tpu_torch/ops`` against ``aldi_tpu/ops``), on the CPU; and the
kernels' custom ops (``ops/custom_ops.py``) under ``torch.library.opcheck``.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs un-jitted. Tolerances: elementwise float32 arithmetic that
both packages do in the same order must agree to a few float32 ulps
(rtol 1e-6); ROIAlign sums in another order than XLA (1e-5 relative to the
feature scale); bfloat16 outputs may round across one bf16 ulp (2^-7 of
the value); integer and boolean results (levels, NMS keep masks) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.ops import anchors as jax_anchors
from aldi_tpu.ops import boxes as jax_boxes
from aldi_tpu.ops import nms as jax_nms
from aldi_tpu.ops import roi_align as jax_roi
from aldi_tpu.ops.pallas_roi_align import roi_align_pallas_batched
from aldi_tpu_torch.ops import anchors as port_anchors
from aldi_tpu_torch.ops import boxes as port_boxes
from aldi_tpu_torch.ops import custom_ops, flash_attn, match_kernel
from aldi_tpu_torch.ops import nms as port_nms
from aldi_tpu_torch.ops import roi_align as port_roi
from aldi_tpu_torch.ops.roi_align_kernel import roi_align_fwd
from tests.torch_port_common import max_err
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


def random_boxes(rng, shape, size=100.0):
    xy = rng.uniform(0, size, shape + (2,))
    wh = rng.uniform(1, size / 2, shape + (2,))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- boxes
BOX_FNS = {
    "pairwise_iou": lambda m, a, b: m.pairwise_iou(a, b),
    "clip_boxes": lambda m, a, b: m.clip_boxes(a * 2 - 50, (70.0, 90.0)),
    "nonempty": lambda m, a, b: m.nonempty(a - a[..., [2, 3, 0, 1]] * 0.5,
                                           0.5),
    "encode_deltas": lambda m, a, b: m.encode_deltas(a, b, (10., 10., 5., 5.)),
    # deltas of +-8 reach the dw/dh clamp at log(1000/16)
    "decode_deltas": lambda m, a, b: m.decode_deltas(
        (b - 50.0) / 6.0, a, (1.0, 1.0, 1.0, 1.0)),
    # [12, 2*4] per-class deltas paired with [12, 4] boxes
    "decode_deltas_per_class": lambda m, a, b: m.decode_deltas(
        (b - 50.0).reshape(12, 8) / 20.0, a[:12], (10.0, 10.0, 5.0, 5.0)),
}


@pytest.mark.parametrize("name", sorted(BOX_FNS))
def test_box_ops_match_jax(name):
    rng = np.random.default_rng(1)
    a, b = random_boxes(rng, (24,)), random_boxes(rng, (24,))
    want = np.asarray(BOX_FNS[name](jax_boxes, jnp.asarray(a), jnp.asarray(b)))
    got = BOX_FNS[name](port_boxes, t(a), t(b)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_scale_clamp_matches_jax():
    assert port_boxes._SCALE_CLAMP == jax_boxes._SCALE_CLAMP


# -------------------------------------------------------------- anchors
@pytest.mark.parametrize("sizes", [[[32, 64, 128, 256, 512]],
                                   [[32], [64], [128], [256], [512]]])
def test_anchor_generator_matches_jax(sizes):
    strides = [4, 8, 16, 32, 64]
    hws = [(-(-96 // s), -(-160 // s)) for s in strides]
    ratios = [[0.5, 1.0, 2.0]]
    want = jax_anchors.AnchorGenerator(sizes, ratios, strides, 0.0)
    got = port_anchors.AnchorGenerator(sizes, ratios, strides, 0.0)
    assert got.num_cell_anchors == want.num_cell_anchors
    for g, w in zip(got(hws), want(hws)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ NMS
def _nms_inputs(seed, g=6, n=48, tied=False):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, (g, n), size=60.0)
    scores = (rng.integers(0, 3, (g, n)) / 2.0 if tied
              else rng.uniform(0, 1, (g, n))).astype(np.float32)
    valid = rng.uniform(0, 1, (g, n)) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("tied", [False, True])
def test_nms_keep_mask_matches_jax(tied):
    """One batched [G, N, N] fixed-point loop against JAX per row; tied
    scores check that the lower index wins."""
    boxes, scores, valid = _nms_inputs(3, tied=tied)
    got = port_nms.nms_keep_mask(t(boxes), t(scores), t(valid), 0.5).numpy()
    for i in range(boxes.shape[0]):
        want = np.asarray(jax_nms.nms_keep_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]), 0.5))
        np.testing.assert_array_equal(got[i], want, err_msg=f"row {i}")


def test_batched_nms_keep_mask_matches_jax():
    boxes, scores, valid = _nms_inputs(5)
    idxs = np.random.default_rng(6).integers(0, 3, scores.shape).astype(
        np.int32)
    got = port_nms.batched_nms_keep_mask(t(boxes), t(scores), t(idxs),
                                         t(valid), 0.5).numpy()
    for i in range(boxes.shape[0]):
        want = np.asarray(jax_nms.batched_nms_keep_mask(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(idxs[i]),
            jnp.asarray(valid[i]), 0.5))
        np.testing.assert_array_equal(got[i], want, err_msg=f"row {i}")


def test_top_k_by_score_matches_jax():
    """Scores rounded to one decimal, so many tie, and the padding rows
    score -inf: ``jax.lax.top_k`` puts the lower index first among equal
    values, and so must the port (the RPN's logits tie exactly over flat
    image regions). Every row, in order."""
    boxes, scores, valid = _nms_inputs(7)
    scores = np.round(scores, 1)
    gb, gs, gv = (x.numpy() for x in port_nms.top_k_by_score(
        t(boxes), t(scores), t(valid), 20))
    for i in range(boxes.shape[0]):
        wb, ws, wv = (np.asarray(x) for x in jax_nms.top_k_by_score(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]), 20))
        np.testing.assert_array_equal(gv[i], wv)
        np.testing.assert_array_equal(gs[i], ws)
        np.testing.assert_array_equal(gb[i], wb)


class _Nms(torch.nn.Module):
    def forward(self, boxes, scores, valid):
        return port_nms.nms_keep_mask(boxes, scores, valid, 0.5)


def _nms_chain(g=2, n=48):
    """Boxes in a chain, each overlapping the next by IoU 0.6 and the one
    after by 0.33, scores falling along it: greedy NMS keeps every other
    box, and the fixed-point loop needs about N steps (several bodies of
    ``_CHECK_EVERY``) to get there."""
    x0 = np.arange(n, dtype=np.float32) * 2.5
    boxes = np.stack([x0, np.zeros(n), x0 + 10.0, np.full(n, 10.0)], -1)
    scores = np.linspace(1.0, 0.1, n, dtype=np.float32)
    return (np.repeat(boxes[None], g, 0).astype(np.float32),
            np.repeat(scores[None], g, 0), np.ones((g, n), bool))


@pytest.mark.parametrize("case", ["random", "tied", "chain"])
def test_nms_while_loop_form_equals_eager(case):
    """``nms_keep_mask`` through a tiny ``torch.export`` runs its
    fixed-point loop as ``while_loop``; the exported mask equals the eager
    loop's and JAX's, on random and on exactly tied scores, and on a chain
    that takes the loop through several bodies."""
    boxes, scores, valid = (_nms_chain() if case == "chain" else
                            _nms_inputs(3, tied=case == "tied"))
    args = (t(boxes), t(scores), t(valid))
    program = torch.export.export(_Nms(), args, strict=False)
    assert any("while_loop" in str(n.target)
               for n in program.graph.nodes if n.op == "call_function")
    got = program.module()(*args)
    want = port_nms.nms_keep_mask(*args, 0.5)
    print(f"NMS while_loop form vs eager ({case}): "
          f"{int((got != want).sum())} of {want.numel()} flags differ")
    assert torch.equal(got, want)
    for i in range(boxes.shape[0]):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(
            jax_nms.nms_keep_mask(jnp.asarray(boxes[i]), jnp.asarray(
                scores[i]), jnp.asarray(valid[i]), 0.5)), err_msg=f"row {i}")
    if case == "chain":
        assert torch.equal(got[0], torch.arange(48) % 2 == 0)


# ------------------------------------------------------------- ROIAlign
STRIDES = [4, 8, 16, 32]


def _roi_inputs(seed, b=2, p=40, c=8, canvas=(96, 160)):
    """Features of four levels, boxes of every level (sqrt-area from 16 to
    900 px), some reaching out of the canvas and some invalid."""
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((b, -(-canvas[0] // s), -(-canvas[1] // s),
                                  c)).astype(np.float32) for s in STRIDES]
    side = np.exp(rng.uniform(np.log(16), np.log(900), (b, p)))
    aspect = np.exp(rng.uniform(-1, 1, (b, p)))
    w, h = side * aspect, side / aspect
    cx = rng.uniform(-20, canvas[1] + 20, (b, p))
    cy = rng.uniform(-20, canvas[0] + 20, (b, p))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     -1).astype(np.float32)
    boxes[:, 0] = [-300.0, -300.0, -250.0, -250.0]  # wholly out of range
    valid = rng.uniform(0, 1, (b, p)) > 0.15
    return feats, boxes, valid


def test_assign_levels_matches_jax():
    _, boxes, _ = _roi_inputs(2, p=400)
    got = port_roi.assign_levels(t(boxes), 2, 5).numpy()
    want = np.asarray(jax_roi.assign_levels(jnp.asarray(boxes), 2, 5))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2, 3}  # every level is used


def _port_roi_align(feats, boxes, valid, dtype=torch.float32):
    return port_roi.roi_align_batched(
        [t(f).to(dtype) for f in feats], t(boxes), t(valid), STRIDES)


def test_roi_align_plain_matches_jax_corner_gather():
    feats, boxes, valid = _roi_inputs(4)
    want = np.asarray(jax_roi.roi_align_batched(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        jnp.asarray(valid), STRIDES, mode="corner_gather"))
    got = _port_roi_align(feats, boxes, valid).numpy()
    assert got.shape == want.shape == (2, 40, 7, 7, 8)
    err = max_err(got, want)
    print(f"roi_align plain vs JAX corner_gather: max abs err {err:.3g}")
    assert err <= 1e-5
    assert np.all(got[~valid] == 0)


def test_roi_align_plain_matches_pallas_interpret():
    """The plain version against the Pallas kernel it replaces, run as the
    JAX package's own tests run it (interpret mode)."""
    feats, boxes, valid = _roi_inputs(5)
    want = np.asarray(roi_align_pallas_batched(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        jnp.asarray(valid), STRIDES, interpret=True))
    got = _port_roi_align(feats, boxes, valid).numpy()
    err = max_err(got, want)
    print(f"roi_align plain vs Pallas (interpret): max abs err {err:.3g}")
    assert err <= 1e-4  # the Pallas kernel interpolates by weight matrices


def test_roi_align_plain_bf16_matches_jax():
    feats, boxes, valid = _roi_inputs(6)
    want = np.asarray(jax_roi.roi_align_batched(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(boxes),
        jnp.asarray(valid), STRIDES, mode="corner_gather").astype(np.float32))
    got = _port_roi_align(feats, boxes, valid, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bf16 ulp of the value: 2^-7 relative
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-6)


def test_roi_align_cpu_tensors_never_launch_the_kernel():
    feats, boxes, valid = _roi_inputs(8, b=1, p=6)
    before = roi_align_fwd.launches
    _port_roi_align(feats, boxes, valid)
    assert roi_align_fwd.launches == before == 0


def test_roi_align_kernel_rejects_cpu_tensors():
    feats, boxes, valid = _roi_inputs(9, b=1, p=6)
    levels = port_roi.box_levels(t(boxes), t(valid), STRIDES)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_fwd([t(f) for f in feats], t(boxes), levels, STRIDES)
    assert roi_align_fwd.launches == 0


# ---------------------------------------------------- the kernels' ops
def _op_cases():
    """Tiny CPU arguments of each of the six custom ops; the differentiable
    inputs of the two forward ops require grad, so their autograd is
    checked too."""
    rng = np.random.default_rng(17)
    anchors = t(random_boxes(rng, (40,), size=60.0))
    gt = t(random_boxes(rng, (2, 5), size=60.0))
    gt_valid = t(np.array([[1, 1, 0, 1, 0], [0, 1, 1, 1, 1]], bool))
    best = match_kernel.match_iou_plain(anchors, gt, gt_valid)[2]
    feats, boxes, valid = _roi_inputs(18, b=2, p=6, c=4, canvas=(48, 64))
    feats = [t(f).requires_grad_(True) for f in feats]
    boxes = t(boxes)
    levels = port_roi.box_levels(boxes, t(valid), STRIDES)
    shapes = [d for f in feats for d in f.shape[1:3]]
    qkv = [t(rng.standard_normal((2, 12, 8)).astype(np.float32))
           for _ in range(4)]
    bh = t(rng.standard_normal((2, 12, 3)).astype(np.float32) * 0.2)
    bw = t(rng.standard_normal((2, 12, 4)).astype(np.float32) * 0.2)
    out, lse = flash_attn.flash_attn_plain(*qkv[:3], bh, bw, 0.35, 3, 4)
    return {
        "match_iou": (anchors, gt, gt_valid),
        "low_quality_mask": (anchors, gt, gt_valid, best),
        "roi_align_fwd": (feats, boxes, levels, STRIDES, 7, 2),
        "roi_align_bwd": (t(rng.standard_normal((2, 6, 7, 7, 4)).astype(
            np.float32)), boxes, levels, shapes, torch.float32, STRIDES, 2),
        "flash_attn_fwd": (*(x.clone().requires_grad_(True)
                             for x in (*qkv[:3], bh, bw)), 0.35, 3, 4),
        "flash_attn_bwd": (*qkv[:3], bh, bw, lse,
                           flash_attn.attn_delta(out, qkv[3]), qkv[3], 0.35,
                           3, 4),
    }


@pytest.mark.parametrize("name", ["match_iou", "low_quality_mask",
                                  "roi_align_fwd", "roi_align_bwd",
                                  "flash_attn_fwd", "flash_attn_bwd"])
def test_kernel_op_passes_opcheck(name):
    """``torch.library.opcheck`` of each kernel's custom op on CPU tensors
    (schema, fake implementation, autograd registration, AOT dispatch), and
    the op's result equal to the plain version it dispatches to."""
    args = _op_cases()[name]
    op = getattr(custom_ops, name)
    result = torch.library.opcheck(op, args)
    print(f"opcheck {name}: {result}")
    assert set(result.values()) == {"SUCCESS"}
    plain = {"match_iou": match_kernel.match_iou_plain,
             "low_quality_mask": match_kernel.low_quality_mask_plain,
             "roi_align_fwd": port_roi.roi_align_plain,
             "flash_attn_fwd": flash_attn.flash_attn_plain,
             "flash_attn_bwd": flash_attn.flash_attn_plain_backward}
    if name == "roi_align_bwd":
        got = op(*args)
        want = port_roi.roi_align_plain_backward(
            args[0], args[1], args[2],
            list(zip(args[3][::2], args[3][1::2])), *args[4:])
    else:
        with torch.no_grad():
            got, want = op(*args), plain[name](*args)
    got, want = ([got], [want]) if torch.is_tensor(got) else (got, want)
    err = max(max_err(a.detach().float(), b.detach().float())
              for a, b in zip(got, want))
    print(f"{name} op vs plain version: max abs err {err:.3g}")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
