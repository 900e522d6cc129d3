"""Port parity of adversarial domain alignment (``aldi_tpu_torch/models/
rcnn.py``: ``grad_reverse``, ``ConvDiscriminator``, ``FCDiscriminator``,
``_align_losses``, ``forward_domain_align``; the target_weak stream of
``engine/train_step.py``) against the JAX package, on the CPU, in float32,
at the tiny R50-FPN of ``tests/test_torch_port_train_step.py`` (ResNet-26,
canvas 128, 3 classes) with DOMAIN_ADAPT.ALIGN's image- and instance-level
discriminators on (hidden widths 256 and 1024, weights 0.01, layer p2 as
the JAX package's defaults).

Both packages get the same seeded weights (the discriminators' included)
and the same draws (the JAX key's, through ``tests/torch_port_draws.py``);
the JAX detector's passes and step run jitted.

Tolerances: the discriminators' logits 1e-5 of their scale; losses 1e-4
relative, gradients 1e-4 of each tensor's largest magnitude (float32
convolutions and matrix products sum in another order in each framework);
parameters after a step 1e-5 absolute, as in
``test_torch_port_train_step.py``; ``grad_reverse`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models.rcnn import ConvDiscriminator as JaxConvDiscriminator
from aldi_tpu.models.rcnn import FCDiscriminator as JaxFCDiscriminator
from aldi_tpu.models.rcnn import grad_reverse as jax_grad_reverse
from aldi_tpu.structures import Instances as JaxInstances
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import (
    jax_variables_to_state_dict, reference_state_dict_to_port)
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models.rcnn import (ConvDiscriminator, FCDiscriminator,
                                        grad_reverse)
from aldi_tpu_torch.structures import Instances
from tests import torch_port_draws as draws_from
from tests.test_torch_port_train_step import (close_rel, daod_cfg, jax_tree,
                                              make_batch, torch_tree)
from tests.torch_port_common import (max_err, seeded_variables,
                                     teacher_ctx_from_jax)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

ALIGN = {"DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
         "DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED": True}
ROIS = {"MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 33}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    with torch_threads(1):
        yield


def align_cfg(get_cfg, saturated=False, **overrides):
    return daod_cfg(get_cfg, saturated=saturated, **{**ALIGN, **overrides})


def rel_err(got, want):
    want = np.asarray(want)
    return max_err(got, want) / max(float(np.abs(want).max()), 1e-6)


def grads_err(module, jgrads):
    """The worst max abs error / tensor scale of ``module``'s gradients
    against a JAX gradient tree, over the tensors JAX has. A tensor the
    pass does not reach (frozen stem and res2; the heads the target_weak
    stream skips) has no gradient in the port and a zero one in JAX."""
    want = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    params = dict(module.named_parameters())
    worst = 0.0
    for name, w in want.items():
        p = params[name]
        if p.grad is None:
            assert not w.abs().max() > 0, name
            continue
        worst = max(worst, rel_err(p.grad.numpy(), w.numpy()))
    return worst


# ------------------------------------------------------------- pieces
def test_grad_reverse_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal((3, 5, 7)).astype(
        np.float32)
    want_y, want_g = jax.value_and_grad(
        lambda t: (jnp.asarray(w) * jax_grad_reverse(t)).sum())(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = grad_reverse(xt)
    assert torch.equal(y.detach(), xt.detach())
    (torch.from_numpy(w) * y).sum().backward()
    assert np.array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert np.array_equal(xt.grad.numpy(), -w)
    close_rel((torch.from_numpy(w) * xt).sum(), want_y, what="forward")


def _flax_tree(module, x, seed):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if getattr(path[-1], "key", "") == "kernel":
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _port_weights(top, params):
    sd = jax_variables_to_state_dict({"params": {top: params}})
    return {k[len(top) + 1:]: v for k, v in sd.items()}


def test_conv_discriminator_matches_jax():
    """Two hidden convs (3x3, VALID: a 9x11 map becomes 5x7), the spatial
    mean and the linear; the logits and the input's gradient."""
    x = np.random.default_rng(2).standard_normal((2, 9, 11, 12)).astype(
        np.float32)
    jd = JaxConvDiscriminator(hidden_dims=(16, 8))
    params = _flax_tree(jd, x, seed=3)
    want, want_g = jax.value_and_grad(
        lambda t: jd.apply({"params": params}, t).sum())(jnp.asarray(x))
    d = ConvDiscriminator(12, (16, 8), torch.float32)
    d.load_state_dict(_port_weights("img_align", params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = d(xt)
    assert out.shape == (2, 1)
    out.sum().backward()
    close_rel(out.sum(), want, rtol=1e-5, what="logits sum")
    err = rel_err(xt.grad.numpy(), want_g)
    print(f"input gradient: max abs err / scale {err:.3g} (tol 1e-4)")
    assert err <= 1e-4


def test_fc_discriminator_matches_jax():
    x = np.random.default_rng(4).standard_normal((6, 40)).astype(np.float32)
    jd = JaxFCDiscriminator(hidden_dims=(32, 16))
    params = _flax_tree(jd, x, seed=5)
    want = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    d = FCDiscriminator(40, (32, 16), torch.float32)
    d.load_state_dict(_port_weights("ins_align", params))
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    err = rel_err(got, want)
    print(f"logits: max abs err / scale {err:.3g} (tol 1e-5)")
    assert got.shape == (6, 1) and err <= 1e-5


def test_discriminator_weights_convert_and_reference_files_skip_them():
    """``jax_variables_to_state_dict`` maps every discriminator leaf; a
    reference file's discriminators are not read (they keep the model's),
    the port's own files' are."""
    jdet = jax_build_detector(align_cfg(jax_get_cfg))
    variables = seeded_variables(jdet, seed=1)
    sd = jax_variables_to_state_dict(variables)
    det = build_detector(align_cfg(port_get_cfg), device="cpu")
    target = det.module.state_dict()
    assert set(sd) == set(target)
    assert {k for k in sd if "_align." in k} == {
        "img_align.conv0.weight", "img_align.conv0.bias",
        "img_align.linear.weight", "img_align.linear.bias",
        "ins_align.linear0.weight", "ins_align.linear0.bias",
        "ins_align.linear_out.weight", "ins_align.linear_out.bias"}
    assert sd["img_align.conv0.weight"].shape == (256, 256, 3, 3)
    assert sd["ins_align.linear0.weight"].shape == (1024, 1024)
    ref = reference_state_dict_to_port(sd, target)
    own = reference_state_dict_to_port(sd, target, convert_layouts=False)
    for k in sd:
        if "_align." in k:
            assert torch.equal(ref[k], target[k]), k
            assert not torch.equal(target[k], sd[k]), k
        assert torch.equal(own[k], sd[k]), k


# --------------------------------------------------------- the passes
@pytest.fixture(scope="module")
def dets():
    jdet = jax_build_detector(align_cfg(jax_get_cfg))
    variables = seeded_variables(jdet, seed=3)
    tdet = build_detector(align_cfg(port_get_cfg), device="cpu")
    return jdet, variables, tdet


def _gt(batch, cls):
    lab = batch["labeled"]
    return cls(boxes=lab["boxes"], classes=lab["classes"],
               valid=lab["valid"])


@pytest.mark.parametrize("domain_label", [1.0, 0.0])
def test_forward_train_with_align_matches_jax(dets, domain_label):
    """``forward_train(..., do_align=True)``: every loss, ``loss_da_img`` and
    ``loss_da_ins`` among them, and every gradient (the backbone's carry the
    reversed discriminators' terms)."""
    jdet, variables, tdet = dets
    batch = make_batch()
    lab = batch["labeled"]
    rng = jax.random.PRNGKey(21)

    def loss_fn(params):
        v = {"params": params, "frozen": variables["frozen"]}
        losses, _ = jdet.forward_train(
            v, jnp.asarray(lab["image"]), jnp.asarray(lab["sizes"]),
            _gt(jax_tree(batch), JaxInstances), rng, do_align=True,
            domain_label=domain_label)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_tree(dict(variables["params"])))
    draws = draws_from.forward_train_draws(rng, tdet.cfg, 2,
                                           tdet.anchors_cat.shape[0])
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    tdet.module.zero_grad(set_to_none=True)
    tb = torch_tree(batch)
    losses, _ = tdet.forward_train(
        tdet.module, tb["labeled"]["image"], tb["labeled"]["sizes"],
        _gt(tb, Instances), draws, do_align=True, domain_label=domain_label)
    assert {"loss_da_img", "loss_da_ins"} <= set(losses)
    assert set(losses) == set(want)
    for k in want:
        close_rel(losses[k].detach(), want[k], what=k)
    sum(losses.values()).backward()
    worst = grads_err(tdet.module, jgrads)
    print(f"gradients: worst max abs err / tensor scale {worst:.3g} "
          f"(tol 1e-4)")
    assert worst <= 1e-4


@pytest.mark.parametrize("ins", [True, False])
def test_forward_domain_align_matches_jax(ins):
    """The target_weak stream (``domain_label`` 0): its losses and every
    gradient; with instance alignment off it runs no RPN and no box
    head."""
    over = {"DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED": ins}
    jdet = jax_build_detector(align_cfg(jax_get_cfg, **over))
    variables = seeded_variables(jdet, seed=4)
    tdet = build_detector(align_cfg(port_get_cfg, **over), device="cpu")
    uw = make_batch(seed=1)["unlabeled"]
    rng = jax.random.PRNGKey(23)

    def loss_fn(params):
        v = {"params": params, "frozen": variables["frozen"]}
        losses, _ = jdet.forward_domain_align(
            v, jnp.asarray(uw["image"]), jnp.asarray(uw["sizes"]), rng, 0.0)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax_tree(dict(variables["params"])))
    draws = draws_from.domain_align_draws(rng, tdet.cfg, 2)
    assert ("roi" in draws) == ins
    tdet.module.load_state_dict(jax_variables_to_state_dict(variables))
    losses = tdet.forward_domain_align(
        tdet.module, torch.from_numpy(uw["image"]),
        torch.from_numpy(uw["sizes"]), draws, domain_label=0.0)
    assert set(losses) == set(want) == (
        {"loss_da_img", "loss_da_ins"} if ins else {"loss_da_img"})
    for k in want:
        close_rel(losses[k].detach(), want[k], what=k)
    sum(losses.values()).backward()
    params = dict(tdet.module.named_parameters())
    head = params["roi_heads.box_head.fc1.weight"]
    assert (head.grad is not None) == ins
    assert params["proposal_generator.rpn_head.conv.weight"].grad is None
    worst = grads_err(tdet.module, jgrads)
    print(f"gradients: worst max abs err / tensor scale {worst:.3g} "
          f"(tol 1e-4)")
    assert worst <= 1e-4


# ---------------------------------------------------------- whole step
@pytest.fixture(scope="module")
def aligned_steps():
    """One DAOD step of both packages with both discriminators, soft
    distillation and one backward per stream; and the port's step with one
    backward at the end. Saturated anchor sampling; 33 ROIs per image, all
    of the target_weak stream's 32 proposals and one empty gt slot (the JAX
    package's sampler takes no more than its candidates)."""
    jcfg = align_cfg(jax_get_cfg, saturated=True, **ROIS)
    jdet = jax_build_detector(jcfg)
    variables = seeded_variables(jdet, seed=5)
    batch = make_batch(seed=2)
    rng = jax.random.PRNGKey(41)
    state, tx = jax_create_train_state(jcfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params,
                          frozen=jax_tree(dict(variables["frozen"])),
                          opt_state=tx.init(params),
                          ema_params=jax_tree(dict(variables["params"])))
    state, m = jax_make_train_step(jcfg, jdet, tx)(state, jax_tree(batch),
                                                  rng)
    want_m = {k: float(v) for k, v in m.items()}
    want = jax_variables_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, state.params)})
    start = jax_variables_to_state_dict(variables)
    uw = batch["unlabeled"]
    ports = []
    for at_end in (False, True):
        cfg = align_cfg(port_get_cfg, saturated=True,
                        **{"SOLVER.BACKWARD_AT_END": at_end, **ROIS})
        det = build_detector(cfg, device="cpu")
        draws = draws_from.train_step_draws(rng, cfg, 2, 2,
                                            det.anchors_cat.shape[0])
        pstate = create_train_state(cfg, det, start)
        with teacher_ctx_from_jax(det, jdet, variables, uw["image"],
                                  uw["sizes"], jax.random.split(rng, 10)[0]):
            pstate, got = make_train_step(cfg, det)(
                pstate, torch_tree(batch), draws)
        ports.append(({k: float(v) for k, v in got.items()},
                      {k: p.detach() for k, p in
                       pstate.student.named_parameters()}))
    return want_m, want, start, ports


def test_aligned_daod_step_matches_jax(aligned_steps):
    """Every loss of the step (``loss_da_*`` of source_strong and
    target_weak among them) and every parameter after it, the
    discriminators' included."""
    want_m, want, start, ((got_m, got_p), _) = aligned_steps
    assert set(got_m) == set(want_m), set(got_m) ^ set(want_m)
    assert {f"loss_da_{k}_{s}" for k in ("img", "ins")
            for s in ("source_strong", "target_weak")} <= set(got_m)
    for k in want_m:
        close_rel(got_m[k], want_m[k], what=k)
    assert want_m["num_pseudo_labels"] > 0
    err = max(max_err(got_p[k].numpy(), w.numpy()) for k, w in want.items())
    disc = [k for k in want if "_align." in k]
    moved = max(max_err(want[k].numpy(), start[k].numpy()) for k in disc)
    disc_err = max(max_err(got_p[k].numpy(), want[k].numpy()) for k in disc)
    print(f"student after the step: max abs err {err:.3g} (tol 1e-5); the "
          f"discriminators' largest move {moved:.3g}, their max abs err "
          f"{disc_err:.3g} (tol 1% of the move)")
    # the discriminators' losses weigh 0.01: their move (~1e-5 at lr 0.01)
    # is held to 1% of itself
    assert err <= 1e-5 and moved > 0 and disc_err <= 0.01 * moved


def test_backward_at_end_matches_stream_backward(aligned_steps):
    """SOLVER.BACKWARD_AT_END true (one backward of the summed streams)
    gives the losses and parameters of false (one backward per stream, the
    target_weak stream's its own)."""
    _, _, _, ((seq_m, seq_p), (joint_m, joint_p)) = aligned_steps
    for k in seq_m:
        close_rel(joint_m[k], seq_m[k], rtol=1e-5, what=k)
    for k, p in seq_p.items():
        assert max_err(joint_p[k].numpy(), p.numpy()) <= 1e-6, k


def test_draw_step_draws_the_target_weak_stream(dets):
    """The target_weak stream takes the ROI sampler's draws over the
    proposals and one empty gt slot, no anchor draws; seeded."""
    _, _, tdet = dets
    a = draw_step(torch.Generator().manual_seed(3), tdet, 2, 2)
    b = draw_step(torch.Generator().manual_seed(3), tdet, 2, 2)
    assert set(a) == {"strong", "aug_labeled", "align", "teacher", "distill",
                      "aug_unlabeled"}
    assert set(a["align"]) == {"roi"}
    assert a["align"]["roi"]["fill"].shape == (2, 32 + 1)
    assert all(torch.equal(a["align"]["roi"][k], b["align"]["roi"][k])
               for k in a["align"]["roi"])
