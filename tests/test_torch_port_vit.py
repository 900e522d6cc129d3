"""Port parity of the ViTDet serving path (``aldi_tpu_torch/models/vit.py``,
``ops/flash_attn.py``, the LN conv box head and the two-conv RPN head)
against the JAX package, on the CPU, in float32.

Both packages get the same seeded weights (the JAX variable tree filled
from numpy, converted with ``jax_variables_to_state_dict``) and the same
inputs; the JAX side runs un-jitted, its Pallas attention in interpret
mode. The tiny ViTDet is that of ``tests/test_backbones.py:22-42``
(``tests/torch_port_common.tiny_vit``).

Tolerances: the attention's forward 1e-5 of the output's scale and its
gradients 1e-4 of each gradient's scale (the same float32 arithmetic,
summed in another order; bfloat16 inputs one bf16 ulp of the output's
scale); the resizes 1e-5 of their scale (the same float32 weights, the
two axes contracted in another order); model stages 1e-4 of
their largest magnitude (float32 matrix products and convolutions sum in
another order in each framework, about 1e-6 relative per layer); the whole
``forward_inference`` boxes 1e-3 px and scores 1e-5, where ``valid``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models import vit as jax_vit
from aldi_tpu.models.roi_heads import FastRCNNConvFCHead as JaxBoxHead
from aldi_tpu.models.rpn import StandardRPNHead as JaxRPNHead
from aldi_tpu.ops.pallas_flash_attn import flash_attention_relpos as jax_attn
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.export import make_serving_fn
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models import vit
from aldi_tpu_torch.models.rcnn import RCNN
from aldi_tpu_torch.models.roi_heads import FastRCNNConvFCHead
from aldi_tpu_torch.models.rpn import StandardRPNHead
from aldi_tpu_torch.ops.flash_attn import flash_attention_relpos
from aldi_tpu_torch.ops.flash_attn_kernel import flash_attn_bwd, flash_attn_fwd
from tests.torch_port_common import (max_err, seeded_variables, tiny_cfg,
                                     tiny_images, tiny_vit,
                                     vitdet_head_config)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _tiny_vit():
    with tiny_vit():
        yield


def _close(got, want, rel=1e-4, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = max_err(got, want)
    scale = float(np.max(np.abs(want), initial=1.0))
    print(f"{what}: max abs err {err:.3g} (scale {scale:.3g})")
    assert err <= rel * scale, what


def _port_weights(module, tree, prefix):
    """A JAX sub-tree (``params`` of one module, nested under the path the
    converter expects) -> the port module's state dict."""
    sd = jax_variables_to_state_dict({"params": tree})
    return module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})


# ------------------------------------------------- (a) flash attention
@contextlib.contextmanager
def _own_compiles():
    """JAX's persistent compilation cache off for the duration. Under
    xdist it is on in the workers (they inherit the conftest's
    JAX_COMPILATION_CACHE_DIR before JAX is imported) and off in a process
    run alone (set after the import): the interpret-mode kernels then
    compile in this process either way."""
    saved = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", saved)


def _attn_inputs(seed, g, hg, wg, d=64):
    rng = np.random.RandomState(seed)
    n = hg * wg
    return [(rng.randn(*s) * sc).astype(np.float32) for s, sc in (
        ((g, n, d), 0.3), ((g, n, d), 0.3), ((g, n, d), 1.0),
        ((g, n, hg), 0.2), ((g, n, wg), 0.2), ((g, n, d), 1.0))]


@pytest.mark.parametrize("hg,wg,g", [(16, 16, 2), (8, 32, 2), (64, 64, 1)])
def test_flash_attention_and_grads_match_pallas(hg, wg, g):
    """Forward and the gradients in q, k, v, Bh and Bw against the Pallas
    kernel in interpret mode: 16x16, the non-square 8x32, and 64x64
    (N=4096, where the Pallas backward tiles its keys)."""
    *args, co = _attn_inputs(hg * wg + g, g, hg, wg)
    scale = 64 ** -0.5

    def jax_loss(a):
        return (jax_attn(*a, scale, hg, wg, interpret=True) * co).sum()

    # the JAX reference first, whole: on buffers of its own (jnp.asarray
    # may alias the numpy inputs that the tensors below share), compiled
    # in this process and read back before PyTorch runs
    jargs = tuple(jnp.array(a, copy=True) for a in args)
    with _own_compiles():
        want_out = np.array(jax_attn(*jargs, scale, hg, wg, interpret=True))
        want_grads = [np.array(w) for w in jax.grad(jax_loss)(jargs)]
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    before = (flash_attn_fwd.launches, flash_attn_bwd.launches)
    out = flash_attention_relpos(*ts, scale, hg, wg)
    (out * torch.from_numpy(co)).sum().backward()
    assert (flash_attn_fwd.launches, flash_attn_bwd.launches) == before
    _close(out.detach(), want_out, 1e-5, "out")
    for t, w, name in zip(ts, want_grads, ("dq", "dk", "dv", "dbh", "dbw")):
        assert t.grad.dtype == torch.float32
        _close(t.grad, w, 1e-4, name)


def test_flash_attention_bfloat16_forward_matches_pallas():
    """bf16 q/k/v: float32 logits, probabilities rounded to bf16 before
    P.V, out in bf16; the gradients come back in the inputs' dtypes."""
    q, k, v, bh, bw, _ = _attn_inputs(7, 2, 8, 8)
    scale = 64 ** -0.5
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_attn(jq, jk, jv, jnp.asarray(bh), jnp.asarray(bw), scale, 8,
                    8, interpret=True)
    tq, tk, tv = (torch.tensor(np.asarray(a.astype(jnp.float32)))
                  .to(torch.bfloat16).requires_grad_(True)
                  for a in (jq, jk, jv))
    tbh = torch.from_numpy(bh).requires_grad_(True)
    out = flash_attention_relpos(tq, tk, tv, tbh, torch.from_numpy(bw),
                                 scale, 8, 8)
    assert out.dtype == torch.bfloat16
    _close(out.float().detach(), np.asarray(want.astype(jnp.float32)),
           2.0 ** -8, "out (bf16)")
    out.float().sum().backward()
    assert tq.grad.dtype == torch.bfloat16 and tbh.grad.dtype == torch.float32


# ---------------------------------------------------- (b) the resizes
@pytest.mark.parametrize("hw", [(64, 128), (8, 8), (20, 9)])
def test_get_abs_pos_matches_jax_bicubic(hw):
    """14x14 -> 64x128 enlarges (the flagship canvas), 8x8 shrinks (the
    tiny canvas: antialiased), 20x9 does both."""
    pos = np.random.default_rng(0).standard_normal((1, 14, 14, 16)).astype(
        np.float32)
    want = jax_vit.get_abs_pos(jnp.asarray(pos), hw)
    got = vit.get_abs_pos(torch.from_numpy(pos), hw)
    _close(got, want, 1e-5, f"get_abs_pos 14x14 -> {hw}")


@pytest.mark.parametrize("size,rows", [(14, 27), (14, 15), (8, 31)])
def test_get_rel_pos_matches_jax(size, rows):
    """A table of 2*size-1 rows is looked up as is; others are first
    resized linearly (enlarged or shrunk)."""
    table = np.random.default_rng(1).standard_normal((rows, 8)).astype(
        np.float32)
    want = jax_vit.get_rel_pos(size, size, jnp.asarray(table))
    got = vit.get_rel_pos(size, size, torch.from_numpy(table))
    _close(got, want, 1e-5, f"get_rel_pos {size} from {rows} rows")


# ------------------------------------------------ (c) the ViT's modules
def _jax_init(module, *xs, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *xs)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        if names[-1] == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan = s.shape[0] if names[-2:] == ["qkv", "kernel"] else (
            np.prod(s.shape[:-1]) if names[-1] == "kernel" else 20.0)
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("window", [0, 4])
def test_attention_matches_jax(window):
    """A global attention (the port's kernel path, JAX's XLA path on the
    CPU) over a 6x10 grid and a window attention over 4x4 windows."""
    hw = (4, 4) if window else (6, 10)
    x = np.random.default_rng(2).standard_normal((3, *hw, 64)).astype(
        np.float32)
    jmod = jax_vit.Attention(64, 2, True, hw)
    variables = _jax_init(jmod, jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    port = vit.Attention(64, 2, hw, use_kernel=not window)
    _port_weights(port, {"backbone": {"block0": {"attn": variables[
        "params"]}}}, "backbone.net.blocks.0.attn.")
    with torch.no_grad():
        _close(port(torch.from_numpy(x)), want, what=f"attention {hw}")


def test_block_with_drop_path_masks_matches_jax():
    """A window block (window 4 over a 6x10 map: padding) with drop path
    0.5; the JAX block's masks are captured and handed to the port."""
    x = np.random.default_rng(3).standard_normal((4, 6, 10, 64)).astype(
        np.float32)
    jmod = jax_vit.Block(64, 2, window_size=4, drop_path=0.5)
    variables = _jax_init(jmod, jnp.asarray(x))
    masks = []
    real = jax.random.bernoulli

    def bernoulli(key, p, shape):
        m = real(key, p, shape)
        masks.append(np.asarray(m).reshape(-1))
        return m

    jax_vit.jax.random.bernoulli = bernoulli
    try:
        want = jmod.apply(variables, jnp.asarray(x), True,
                          rngs={"dropout": jax.random.PRNGKey(4)})
    finally:
        jax_vit.jax.random.bernoulli = real
    assert len(masks) == 2 and not masks[0].all() and masks[0].any()
    port = vit.Block(64, 2, 4, (6, 10), drop_path=0.5)
    _port_weights(port, {"backbone": {"block0": variables["params"]}},
                  "backbone.net.blocks.0.")
    with torch.no_grad():
        got = port(torch.from_numpy(x), *(torch.tensor(m) for m in masks))
    _close(got, want, what="block with drop path")


def test_vit_and_feature_pyramid_match_jax():
    """The tiny ViT trunk over a 128x96 image (8x6 grid: the window blocks
    pad, the global block takes the whole grid), then the
    SimpleFeaturePyramid on its output."""
    x = np.random.default_rng(5).standard_normal((2, 128, 96, 3)).astype(
        np.float32)
    cfg = jax_vit.VIT_CONFIGS["b"]
    jnet = jax_vit.ViT(**cfg, use_act_checkpoint=False)
    net_vars = _jax_init(jnet, jnp.asarray(x))
    want = jnet.apply(net_vars, jnp.asarray(x))
    jsfp = jax_vit.SimpleFeaturePyramid(out_channels=32)
    sfp_vars = _jax_init(jsfp, want, seed=1)
    want_p = jsfp.apply(sfp_vars, want)

    port = vit.ViTDetBackbone("b", (8, 6), out_channels=32,
                              use_act_checkpoint=False)
    _port_weights(port, {"backbone": net_vars["params"],
                         "sfp": sfp_vars["params"]}, "backbone.")
    with torch.no_grad():
        trunk = port.net(torch.from_numpy(x).permute(0, 3, 1, 2))
        levels = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(trunk, want, what="ViT trunk")
    for i, lv in enumerate(levels):
        _close(lv.permute(0, 2, 3, 1), want_p[f"p{i + 2}"],
               what=f"feature pyramid p{i + 2}")


# ----------------------------------------------------- (d) the heads
def test_ln_conv_box_head_matches_jax():
    x = np.random.default_rng(6).standard_normal((5, 7, 7, 32)).astype(
        np.float32)
    jmod = JaxBoxHead(num_fc=1, fc_dim=48, num_conv=2, conv_dim=16, norm="LN")
    variables = _jax_init(jmod, jnp.asarray(x))
    port = FastRCNNConvFCHead(32, 7, num_fc=1, fc_dim=48, num_conv=2,
                              norm="LN", conv_dim=16)
    _port_weights(port, {"box_head": variables["params"]},
                  "roi_heads.box_head.")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, jmod.apply(variables, jnp.asarray(x)), what="LN box head")


def test_two_conv_rpn_head_matches_jax():
    feats = [np.random.default_rng(7 + i).standard_normal(
        (2, s, s + 2, 16)).astype(np.float32) for i, s in enumerate((8, 4))]
    jmod = JaxRPNHead(num_anchors=3, conv_dim=16, conv_dims=(-1, -1))
    variables = _jax_init(jmod, [jnp.asarray(f) for f in feats])
    want = jmod.apply(variables, [jnp.asarray(f) for f in feats])
    port = StandardRPNHead(16, 3, conv_dims=(-1, -1))
    _port_weights(port, {"rpn_head": variables["params"]},
                  "proposal_generator.rpn_head.")
    assert {"conv0.weight", "conv1.weight"} <= set(port.state_dict())
    with torch.no_grad():
        got = port([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for i in range(2):
        _close(got[0][i], want[0][i], what=f"objectness level {i}")
        _close(got[1][i], want[1][i], what=f"deltas level {i}")


# --------------------------------------- (e) the whole serving path
def test_vitdet_forward_inference_matches_jax():
    jcfg = vitdet_head_config(tiny_cfg(jax_get_cfg))
    tcfg = vitdet_head_config(tiny_cfg(port_get_cfg))
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed=0)
    tdet = build_detector(tcfg, device="cpu")
    weights = jax_variables_to_state_dict(variables)
    assert set(weights) == set(tdet.module.state_dict())
    images, sizes = tiny_images()
    want = [np.asarray(a) for a in jdet.forward_inference(
        variables, jnp.asarray(images), jnp.asarray(sizes))]
    before = flash_attn_fwd.launches
    got = make_serving_fn(tdet, weights)(images, sizes)
    assert flash_attn_fwd.launches == before  # CPU: the plain version
    m = want[3]
    assert m.sum(1).min() > 0
    np.testing.assert_array_equal(got["valid"].numpy(), m)
    box_err = max_err(got["boxes"].numpy()[m], want[0][m])
    score_err = max_err(got["scores"].numpy()[m], want[1][m])
    print(f"ViTDet forward_inference: boxes max abs err {box_err:.3g}, "
          f"scores {score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-5
    np.testing.assert_array_equal(got["classes"].numpy()[m], want[2][m])


def test_vitdet_l_builds_from_the_same_code():
    """build_vitdet_l_backbone at its published widths (the tiny patch
    applies to "b" only): 24 blocks of 1024, 16 heads, global blocks 5, 11,
    17, 23."""
    with torch.device("meta"):  # shapes only: no 300M weights drawn
        net = RCNN(3, 3, backbone_name="build_vitdet_l_backbone",
                   grid=(8, 8)).backbone.net
    assert len(net.blocks) == 24 and net.embed_dim == 1024
    assert [i for i, b in enumerate(net.blocks) if b.attn.use_kernel] == [
        5, 11, 17, 23]
    assert net.blocks[0].attn.num_heads == 16


def test_vitdet_defaults_to_cuda_and_kernels_refuse_cpu(monkeypatch):
    """Without a GPU the ViTDet detector's default device raises; the
    kernels' wrappers take CUDA tensors only (the CPU path is the
    dispatcher's choice for the custom op, never the wrappers')."""
    cfg = vitdet_head_config(tiny_cfg(port_get_cfg))
    q = torch.zeros((1, 64, 64))
    b = torch.zeros((1, 64, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attn_fwd(q, q, q, b, b, 0.125, 8, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attn_bwd(q, q, q, b, b, b[..., 0], b[..., 0], q, 0.125, 8, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detector(cfg)
