"""Port parity of Deformable DETR's forward against the JAX package, on the
CPU, at the sizes of ``tests/test_detr.py:12`` (2 + 2 layers, d_model 64,
4 heads, 20 queries, 3 classes, canvas 128; the R50 at its full depth, as
both packages build it whatever RESNETS.DEPTH says), float32.

Both packages get the same seeded weights (``tests/torch_port_common.py``
``detr_variables``, carried across by ``jax_variables_to_state_dict``) and
the same numpy inputs. Tolerances: the MSDA core and its gradients 1e-5 of
each output's scale; the position embeddings 1e-5 absolute; the forward's
per-layer logits and boxes 1e-4 of their scale (50 convolution layers and
the transformer in float32, each summing in another order); detections
1e-3 px and 1e-5 in score, classes equal. The whole network runs jitted in
JAX, the small functions un-jitted.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine.checkpoint_convert import torch_state_dict_to_tree
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models.detr import proposal_pos_embed as jax_proposal_pos_embed
from aldi_tpu.models.detr import (sine_position_embedding as
                                  jax_sine_position_embedding)
from aldi_tpu.ops.ms_deform_attn import (ms_deform_attn_core as
                                         jax_ms_deform_attn_core)
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import (
    jax_variables_to_state_dict, reference_state_dict_to_port)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models.detr import (proposal_pos_embed,
                                        sine_position_embedding)
from aldi_tpu_torch.ops.ms_deform_attn import ms_deform_attn_core
from tests.torch_detr_oracle import (build_deformable_detr,
                                     golden_deformable_detr_names)
from tests.torch_port_common import ALDI_DETR, detr_cfg, detr_variables
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_rcnn_oracle import randomize

VARIANTS = {
    "shipped": {},
    "box_refine": {"MODEL.DEFORMABLE_DETR.WITH_BOX_REFINE": True},
    "two_stage": {"MODEL.DEFORMABLE_DETR.TWO_STAGE": True},
    "refine_two_stage": {"MODEL.DEFORMABLE_DETR.WITH_BOX_REFINE": True,
                         "MODEL.DEFORMABLE_DETR.TWO_STAGE": True},
    "dc5_learned": {"MODEL.DEFORMABLE_DETR.DILATION": True,
                    "MODEL.DEFORMABLE_DETR.POSITION_EMBEDDING": "learned"},
}


def scaled(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def padded_batch(seed=0):
    """Two images of the 128 canvas: one full, one padded to 96x112."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 255, (2, 128, 128, 3)).astype(np.float32)
    sizes = np.array([[128, 128], [96, 112]], np.int32)
    images[1, 96:] = 0.0
    images[1, :, 112:] = 0.0
    return images, sizes


def detectors(variant, seed=0):
    """(JAX detector, its variables, the port's detector on the CPU with
    the same weights) of the tiny config with ``variant``'s options."""
    over = VARIANTS[variant]
    jdet = jax_build_detector(detr_cfg(jax_get_cfg, **over))
    variables = jax.tree_util.tree_map(np.asarray,
                                       detr_variables(jdet, seed))
    det = build_detector(detr_cfg(port_get_cfg, **over), device="cpu")
    det.module.load_state_dict(jax_variables_to_state_dict(variables))
    return jdet, variables, det


# ------------------------------------------------------------------ MSDA
def msda_inputs(seed=0):
    """value, shapes, locations (some outside every level) and softmaxed
    weights of 2 images, 3 heads of 8 channels, 3 levels, 4 points."""
    rng = np.random.default_rng(seed)
    shapes = [(8, 12), (4, 6), (2, 3)]
    lv = sum(h * w for h, w in shapes)
    b, lq, nh, d, n_levels, p = 2, 7, 3, 8, len(shapes), 4
    value = rng.standard_normal((b, lv, nh, d)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (b, lq, nh, n_levels, p, 2)).astype(
        np.float32)
    loc[0, 0] = -0.7  # every sample of a query outside every level
    loc[1, 1, :, :, :, 0] = 1.6
    logits = rng.standard_normal((b, lq, nh, n_levels * p))
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, shapes, loc, w.reshape(b, lq, nh, n_levels, p).astype(
        np.float32)


def test_ms_deform_attn_core_matches_jax():
    value, shapes, loc, w = msda_inputs()
    want = np.asarray(jax_ms_deform_attn_core(jnp.asarray(value), shapes,
                                              jnp.asarray(loc),
                                              jnp.asarray(w)))
    got = ms_deform_attn_core(torch.from_numpy(value), shapes,
                              torch.from_numpy(loc), torch.from_numpy(w))
    err = scaled(got.numpy(), want)
    print(f"MSDA forward: max err / scale {err:.3g}")
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert err <= 1e-5
    # queries sampling outside every level read zeros
    assert np.abs(want[0, 0]).max() == 0.0
    assert float(got[0, 0].abs().max()) == 0.0


def test_ms_deform_attn_core_gradients_match_jax():
    """The gradients of sum(out * cotangent) with respect to the value,
    the locations and the weights."""
    value, shapes, loc, w = msda_inputs(seed=1)
    ct = np.random.default_rng(2).standard_normal(
        (value.shape[0], loc.shape[1], value.shape[2] * value.shape[3])
    ).astype(np.float32)

    def jax_loss(v, lc, wt):
        return (jax_ms_deform_attn_core(v, shapes, lc, wt) * ct).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    args = [torch.from_numpy(a).requires_grad_() for a in (value, loc, w)]
    (ms_deform_attn_core(args[0], shapes, args[1], args[2])
     * torch.from_numpy(ct)).sum().backward()
    for name, a, g in zip(("value", "locations", "weights"), args, want):
        err = scaled(a.grad.numpy(), np.asarray(g))
        print(f"MSDA d/d{name}: max err / scale {err:.3g}")
        assert err <= 1e-5, name


# --------------------------------------------------- position embeddings
def test_position_embeddings_match_jax():
    mask = np.zeros((2, 9, 13), bool)
    mask[0] = True
    mask[1, :6, :10] = True
    want = np.asarray(jax_sine_position_embedding(jnp.asarray(mask), 64))
    got = sine_position_embedding(torch.from_numpy(mask), 64).numpy()
    print(f"sine: max abs err {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    coords = np.random.default_rng(3).standard_normal((2, 5, 4)).astype(
        np.float32) * 3
    want = np.asarray(jax_proposal_pos_embed(jnp.asarray(coords), 64))
    got = proposal_pos_embed(torch.from_numpy(coords), 64).numpy()
    print(f"proposal: max abs err {np.abs(got - want).max():.3g}")
    assert got.shape == (2, 5, 128)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant):
    """Per-layer logits and boxes (and the two-stage encoder outputs) on a
    padded batch of two image sizes."""
    jdet, variables, det = detectors(variant)
    images, sizes = padded_batch()
    want = jax.jit(lambda v, x, s: jdet._fwd(v, x, s, False))(
        variables, images, sizes)
    with torch.no_grad():
        got = det._fwd(None, torch.from_numpy(images),
                       torch.from_numpy(sizes), False)
    assert set(got) == set(want)
    for k, w in want.items():
        err = scaled(got[k].numpy(), np.asarray(w))
        print(f"{variant} {k} {tuple(w.shape)}: max err / scale {err:.3g}")
        assert got[k].shape == w.shape
        assert err <= 1e-4, k


def check_detections(got, want):
    jb, js, jc, jv = (np.asarray(x) for x in want)
    tb, ts, tc, tv = (x.numpy() for x in got)
    assert np.array_equal(tv, jv) and np.array_equal(tc, jc)
    box_err, score_err = np.abs(tb - jb).max(), np.abs(ts - js).max()
    print(f"detections: boxes max abs err {box_err:.3g} px, scores "
          f"{score_err:.3g}")
    assert box_err <= 1e-3 and score_err <= 1e-5


def test_inference_and_teacher_ctx_match_jax():
    """``forward_inference`` (sigmoid, top-k over Q*K, boxes scaled and
    clipped) and ``forward_teacher_ctx``'s pseudo-labels."""
    jdet, variables, det = detectors("shipped", seed=1)
    images, sizes = padded_batch(seed=1)
    want = jax.jit(jdet.forward_inference)(variables, images, sizes)
    got = det.forward_inference(torch.from_numpy(images),
                                torch.from_numpy(sizes))
    check_detections(got, want)

    _, want_gt, want_m = jax.jit(lambda v, x, s: jdet.forward_teacher_ctx(
        v, x, s, jax.random.PRNGKey(0), threshold=0.5, max_gt=8))(
            variables, images, sizes)
    ctx, got_gt, got_m = det.forward_teacher_ctx(
        None, torch.from_numpy(images), torch.from_numpy(sizes),
        threshold=0.5, max_gt=8)
    assert ctx == {}
    assert np.array_equal(got_gt.valid.numpy(), np.asarray(want_gt.valid))
    assert np.array_equal(got_gt.classes.numpy(),
                          np.asarray(want_gt.classes))
    assert np.abs(got_gt.boxes.numpy() - np.asarray(want_gt.boxes)).max() \
        <= 1e-3
    assert 0 < float(got_m["num_pseudo_labels"]) == pytest.approx(
        float(want_m["num_pseudo_labels"]))


# ------------------------------------------------------------ converters
@pytest.mark.parametrize("variant", ["shipped", "refine_two_stage",
                                     "dc5_learned"])
def test_converter_covers_every_parameter_and_buffer(variant):
    """JAX -> port covers the port's state dict one to one: every port
    tensor comes from one JAX leaf with its values (the decoder's
    attention packs three flax kernels into one), and every JAX leaf is
    used."""
    jdet, variables, det = detectors(variant)
    sd = jax_variables_to_state_dict(variables)
    port = det.module.state_dict()
    assert set(sd) == set(port)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    n_attn = sum(k.endswith("self_attn.in_proj_weight") for k in sd)
    # q, k, v kernels and biases -> in_proj_weight and in_proj_bias
    assert n_leaves == len(sd) + 4 * n_attn
    for k, v in port.items():
        assert torch.equal(v, sd[k]), k
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    values = {"/".join(p.key for p in path): a for path, a in flat}
    enc0 = "params/enc0/self_attn/sampling_offsets/kernel"
    assert np.array_equal(
        sd["transformer.encoder.layers.0.self_attn.sampling_offsets.weight"]
        .numpy(), values[enc0].T)
    q = values["params/dec1/self_attn/query/kernel"]
    assert np.array_equal(
        sd["transformer.decoder.layers.1.self_attn.in_proj_weight"][:64]
        .numpy(), q.reshape(64, -1).T)


def _official_checkpoint(seed=13, **kwargs):
    """A state dict under the official Deformable-DETR names (the test
    oracle's module, whose shared heads repeat at every index), random."""
    root = build_deformable_detr(3, d_model=64, d_ff=128, n_heads=4,
                                 enc_layers=2, dec_layers=2, num_queries=20,
                                 **kwargs)
    randomize(root, seed=seed)
    return root


@pytest.mark.parametrize("variant,kwargs", [
    ("shipped", {}),
    ("refine_two_stage", {"with_box_refine": True, "two_stage": True}),
])
def test_official_checkpoint_loads_as_in_jax(variant, kwargs):
    """An official-name ``.pth`` (``golden_deformable_detr_names``, with the
    shared heads' duplicates) loads into the port by name, to the same
    weights as the JAX package's converter gives; the R50 also loads from
    torchvision's bare ImageNet names."""
    root = _official_checkpoint(**kwargs)
    ref = {k: v for k, v in root.state_dict().items()
           if "num_batches_tracked" not in k}
    golden = golden_deformable_detr_names(2, 2, **kwargs)
    alias = re.compile(r"^(class_embed|bbox_embed)\.[1-9]")
    shared = not kwargs.get("with_box_refine")
    assert {k for k in ref if not (shared and alias.match(k))} == golden
    jdet, variables, det = detectors(variant, seed=3)
    target = det.module.state_dict()
    assert set(target) == golden
    got = reference_state_dict_to_port(ref, target)
    params, frozen = torch_state_dict_to_tree(
        {k: v.numpy() for k, v in ref.items()}, variables["params"],
        variables["frozen"])
    want = jax_variables_to_state_dict({"params": params, "frozen": frozen})
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], ref[k]), k
        assert torch.equal(got[k], v), k
    # the bare torchvision names of an ImageNet R50
    body = "backbone.0.body."
    imagenet = {k[len(body):]: v for k, v in ref.items()
                if k.startswith(body)}
    got_tv = reference_state_dict_to_port(imagenet, target)
    for k, v in got_tv.items():
        want_v = ref[k] if k.startswith(body) else target[k]
        assert torch.equal(v, want_v), k


def test_published_config_builds_on_the_cpu():
    """``build_detector`` of ``ALDI-Best-DETR-Cityscapes.yaml``: the
    official names of a 6 + 6 model, and the JAX module's parameter count
    (its trainable and frozen collections)."""
    cfg = port_get_cfg()
    cfg.merge_from_file(ALDI_DETR)
    det = build_detector(cfg, device="cpu")
    assert det.canvas == (800, 1344) and det.dtype == torch.float32
    names = set(det.module.state_dict())
    assert names == golden_deformable_detr_names(6, 6)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(ALDI_DETR)
    jdet = jax_build_detector(jcfg)
    shapes = jax.eval_shape(jdet.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[64, 64]]))
    count = {coll: sum(math.prod(s.shape)
                       for s in jax.tree_util.tree_leaves(tree))
             for coll, tree in shapes.items()}
    n_params = sum(p.numel() for p in det.module.parameters())
    n_buffers = sum(b.numel() for b in det.module.buffers())
    print(f"published DETR: {n_params} parameters, {n_buffers} FrozenBN "
          f"entries; JAX {count}")
    assert n_params == count["params"] and n_buffers == count["frozen"]
    frozen = [n for n, p in det.module.named_parameters()
              if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.0.body.conv1",
                                        "backbone.0.body.layer1."))
                          for n in frozen)
