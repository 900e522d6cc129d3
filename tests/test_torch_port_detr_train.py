"""Port parity of Deformable DETR's training side against the JAX package,
on the CPU, at the sizes of ``tests/test_torch_port_detr.py`` (2 + 2
layers, d_model 64, 4 heads, 20 queries, 3 classes, canvas 128, MAX_GT 8),
float32, with the ALDI-Best-DETR recipe (``configs/cityscapes/ALDI-Best-
DETR-Cityscapes.yaml``: labeled_strong + unlabeled_strong, EMA from step 0,
the soft distill flags that both packages map to hard pseudo-label
self-training, erasing on the labeled stream and MIC on the unlabeled one,
AdamW with DETR's multipliers, gradient clipping at norm 0.1) at DROPOUT 0:
JAX's masks come from ``jax.random`` and cannot be reproduced.

- The assignment solver: ``lapjv_plain`` against the JAX package's
  ``lapjv`` exactly (col4row equal) on random costs, on costs with ties
  (duplicated rows, columns clipped to 1e4) and for every ``n_rows`` from 0
  to n; its cost equal to scipy's ``linear_sum_assignment``.
- ``hungarian_match`` (assignments equal) and ``detr_losses_all_layers``
  (1e-5 relative) against JAX on the same predictions.
- Two DAOD steps against the JAX package's jitted step (its compile takes
  about 45 s): losses within 1e-4 relative; the student's and the
  teacher's parameters within 2 * the summed learning rates of the steps
  taken (AdamW's first steps move an entry by about lr * sign(g), and an
  entry whose gradient sits at float32 noise can move either way: measured
  2e-5 after the first step, 1e-4 after the second), with at most 0.1% of
  the entries beyond 1e-6 (measured 0.008% and 0.05%); the teacher's
  ``query_embed`` copied through, not blended. The distill stream's losses
  are the student's standard losses on the pseudo-labels, ungated and
  non-zero, as in JAX.
- The port alone: the dropout draws, TPU.GRAD_ACCUM 2, the ADAMW
  multipliers against optax, ``train_net`` with a resume and an eval, and
  the artifact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.models.detr import (detr_losses_all_layers as
                                  jax_detr_losses_all_layers)
from aldi_tpu.models.detr import hungarian_match as jax_hungarian_match
from aldi_tpu.ops.lapjv import lapjv as jax_lapjv
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.engine.distill import gate_hard_losses
from aldi_tpu_torch.engine.export import (export_inference, load_artifact,
                                          make_serving_fn, save_artifact)
from aldi_tpu_torch.engine.train_step import (create_train_state, draw_step,
                                              make_train_step)
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.models.detr import (_Dropout, detr_losses_all_layers,
                                        hungarian_match)
from aldi_tpu_torch.ops.lapjv import lapjv, lapjv_plain, solve_assignment
from aldi_tpu_torch.solver import build_optimizer, set_lr
from aldi_tpu_torch.tools import train_net
from tests.test_torch_port_yolo_train import (_np, _tree, make_batch,
                                              no_tensorboard, step_draws)
from tests.torch_port_common import (detr_cfg, detr_variables,
                                     drop_weight_files, loader_cfg,
                                     register_synthetic_both)
from tests.torch_port_threads import capped_torch_threads  # noqa: F401

__all__ = ["no_tensorboard"]  # a fixture of the trainer test

STEP = {"EMA.ALPHA": 0.9, "DOMAIN_ADAPT.TEACHER.THRESHOLD": 0.5}


def step_cfg(get_cfg, **overrides):
    """The tiny ALDI-Best-DETR recipe with EMA.ALPHA 0.9 (the published
    0.9996 would move the teacher below the tolerance) and
    TEACHER.THRESHOLD 0.5 (the seeded weights' scores are below the
    published 0.8)."""
    return detr_cfg(get_cfg, **{**STEP, **overrides})


# ------------------------------------------------------------ the solver
def tied_costs(rng, p, n, m):
    """Costs on a grid of quarters, about a third of the rows a copy of the
    row before, a fifth of the columns clipped to 1e4."""
    cost = rng.integers(-8, 9, (p, n, m)).astype(np.float32) / 4
    for r in range(1, n):
        dup = rng.uniform(size=p) < 0.3
        cost[dup, r] = cost[dup, r - 1]
    cost[:, :, rng.uniform(size=m) < 0.2] = 1e4
    return cost


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_lapjv_plain_equals_jax_exactly(kind):
    """col4row exactly equal to the JAX package's ``lapjv`` for every
    ``n_rows`` from 0 to n; the assignment a permutation whose cost equals
    scipy's (1e-6 of the summed magnitude)."""
    rng = np.random.default_rng(0 if kind == "random" else 1)
    n, m = 7, 12
    p = n + 1
    cost = (rng.standard_normal((p, n, m)).astype(np.float32)
            if kind == "random" else tied_costs(rng, p, n, m))
    n_rows = np.arange(n + 1, dtype=np.int32)  # problem i solves i rows
    want = np.asarray(jax.jit(jax.vmap(jax_lapjv))(jnp.asarray(cost),
                                                   jnp.asarray(n_rows)))
    got, settles = lapjv_plain(torch.from_numpy(cost),
                               torch.from_numpy(n_rows))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(lapjv(torch.from_numpy(cost),
                                torch.from_numpy(n_rows)).numpy(), want)
    print(f"{kind}: settles per problem {settles.tolist()}")
    assert settles[0] == 0 and (settles.numpy()[1:] >= n_rows[1:]).all()
    for i, k in enumerate(n_rows):
        cols = want[i, :k]
        assert (want[i, k:] == -1).all()
        assert len(set(cols.tolist())) == k and (cols >= 0).all()
        r, c = linear_sum_assignment(cost[i, :k].astype(np.float64))
        best = cost[i, :k].astype(np.float64)[r, c]
        mine = cost[i, np.arange(k), cols].astype(np.float64).sum()
        assert abs(mine - best.sum()) <= 1e-6 * np.abs(best).sum() + 1e-6


def test_solve_assignment_any_shape():
    rng = np.random.default_rng(4)
    for shape in ((5, 9), (9, 5)):
        cost = rng.standard_normal(shape).astype(np.float32)
        rows, cols = solve_assignment(torch.from_numpy(cost))
        r, c = linear_sum_assignment(cost)
        assert rows.tolist() == sorted(rows.tolist()) == r.tolist()
        assert cost[rows.numpy(), cols.numpy()].sum() == pytest.approx(
            cost[r, c].sum(), rel=1e-6)


# --------------------------------------------------------- the criterion
def criterion_inputs(seed=0, n_layers=3, b=2, q=20, k=3, g=8):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n_layers, b, q, k)).astype(np.float32) * 2
    boxes = rng.uniform(0.1, 0.6, (n_layers, b, q, 4)).astype(np.float32)
    gt = rng.uniform(0.1, 0.6, (b, g, 4)).astype(np.float32)
    classes = rng.integers(0, k, (b, g)).astype(np.int32)
    valid = np.zeros((b, g), bool)
    valid[0, [0, 2, 3, 6]] = True  # valid slots among padding
    valid[1, :g] = True
    return logits, boxes, gt, classes, valid


def test_hungarian_match_and_losses_match_jax():
    logits, boxes, gt, classes, valid = criterion_inputs()
    j_idx, j_valid = jax.jit(jax_hungarian_match)(
        logits[0], boxes[0], gt, classes, valid)
    t = [torch.from_numpy(a) for a in (logits, boxes, gt, classes, valid)]
    idx, pv = hungarian_match(t[0][0], t[1][0], t[2], t[3], t[4])
    assert np.array_equal(idx.numpy(), np.asarray(j_idx))
    assert np.array_equal(pv.numpy(), np.asarray(j_valid))
    num_boxes = float(valid.sum())
    want = jax.jit(jax_detr_losses_all_layers, static_argnums=(5, 6))(
        logits, boxes, gt, classes, valid, 3, 0.25, num_boxes)
    t[0].requires_grad_()
    got = detr_losses_all_layers(*t, 3, 0.25, torch.tensor(num_boxes))
    for name, g, w in zip(("ce", "bbox", "giou"), got, want):
        err = float(np.abs(g.detach().numpy() - np.asarray(w)).max()
                    / np.abs(np.asarray(w)).max())
        print(f"loss_{name} per layer {g.tolist()}: max err / scale "
              f"{err:.3g}")
        assert g.shape == (3,) and err <= 1e-5
    got[0].sum().backward()  # the logits' gradient flows past the matcher
    assert t[0].grad.abs().sum() > 0


# ------------------------------------------------------ two DAOD steps
def jax_steps(cfg, variables, batches, rngs):
    jdet = jax_build_detector(cfg)
    state, tx = jax_create_train_state(cfg, jdet, jax.random.PRNGKey(0))
    params = _tree(variables["params"], jnp.asarray)
    state = state.replace(params=params,
                          frozen=_tree(variables["frozen"], jnp.asarray),
                          opt_state=tx.init(params),
                          ema_params=_tree(variables["params"], jnp.asarray))
    step = jax_make_train_step(cfg, jdet, tx)
    out = []
    for batch, rng in zip(batches, rngs):
        state, m = step(state, _tree(batch, jnp.asarray), rng)
        out.append(({k: float(v) for k, v in m.items()},
                    jax_variables_to_state_dict(_np(
                        {"params": state.params})),
                    jax_variables_to_state_dict(_np(
                        {"params": state.ema_params}))))
    return out


def port_steps(cfg, variables, batches, draws):
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det,
                               jax_variables_to_state_dict(variables))
    step = make_train_step(cfg, det)
    out = [({}, params_of(state.student), params_of(state.teacher))]
    for batch, d in zip(batches, draws):
        state, m = step(state, _tree(batch, torch.from_numpy), d)
        out.append(({k: float(v) for k, v in m.items()},
                    params_of(state.student), params_of(state.teacher)))
    return out, det


def params_of(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


@pytest.fixture(scope="module")
def two_steps():
    """(JAX's, the port's) per step (metrics, student, teacher); the port's
    list starts with the state before the first step."""
    jcfg, tcfg = step_cfg(jax_get_cfg), step_cfg(port_get_cfg)
    variables = _np(detr_variables(jax_build_detector(jcfg), seed=5))
    batches = [make_batch(seed=s) for s in (0, 1)]
    rngs = [jax.random.PRNGKey(s) for s in (41, 42)]
    want = jax_steps(jcfg, variables, batches, rngs)
    got, det = port_steps(tcfg, variables, batches,
                          [step_draws(r, tcfg, 2) for r in rngs])
    return want, got, tcfg


def test_two_daod_steps_losses_match_jax(two_steps):
    want, got, _ = two_steps
    for i, ((wm, _, _), (gm, _, _)) in enumerate(zip(want, got[1:])):
        assert set(gm) == set(wm), sorted(set(gm) ^ set(wm))
        for k, w in wm.items():
            print(f"step {i + 1} {k}: {gm[k]:.6g} vs {w:.6g}")
            assert abs(gm[k] - w) <= 1e-4 * max(abs(w), 1e-3), k
        assert wm["num_pseudo_labels"] > 0


def test_two_daod_steps_parameters_match_jax(two_steps):
    want, got, cfg = two_steps
    lr = cfg.SOLVER.BASE_LR
    for i, (_, ws, wt) in enumerate(want):
        _, gs, gt = got[i + 1]
        for who, g, w in (("student", gs, ws), ("teacher", gt, wt)):
            assert set(g) == set(w)
            worst = max(float((g[k] - w[k]).abs().max()) for k in w)
            far = sum(int(((g[k] - w[k]).abs() > 1e-6).sum()) for k in w)
            share = far / sum(v.numel() for v in w.values())
            print(f"step {i + 1} {who}: max abs err {worst:.3g}, share of "
                  f"entries beyond 1e-6 {share:.3g}")
            assert worst <= 2 * lr * (i + 1) and share <= 1e-3, who


def test_teacher_copies_query_embed_and_blends_the_rest(two_steps):
    """EMA.START_ITER 0: the first step's EMA copies the student; the
    second blends, except ``query_embed``, copied through (``aldi/ema.py:
    17``), as in JAX."""
    want, got, cfg = two_steps
    (_, s0, _), (_, s1, t1), (_, _, t2) = got
    alpha = cfg.EMA.ALPHA
    for k in s0:
        assert torch.equal(t1[k], s0[k]), k
        if "query_embed" in k:
            assert torch.equal(t2[k], s1[k]), k
        else:
            assert torch.allclose(t2[k], alpha * t1[k] + (1 - alpha) * s1[k],
                                  rtol=2e-7, atol=1e-8), k
    assert not torch.equal(t2["query_embed.weight"], t1["query_embed.weight"])
    jt2 = want[1][2]["query_embed.weight"]
    assert torch.allclose(t2["query_embed.weight"], jt2, rtol=0, atol=1e-6)


def test_distill_losses_pass_ungated_and_match_jax(two_steps):
    """DETR's ``gate_hard`` is False: the distill stream's standard losses
    are not gated by the HARD_* flags (all off in the published YAML), as
    the JAX step does; ``gate_hard_losses`` would zero every one."""
    want, got, cfg = two_steps
    gm, wm = got[1][0], want[0][0]
    keys = [k for k in wm if k.endswith("_distill")]
    assert {"loss_ce_distill", "loss_bbox_distill",
            "loss_giou_distill"} <= set(keys)
    for k in keys:
        assert gm[k] > 0 and abs(gm[k] - wm[k]) <= 1e-4 * wm[k], k
    zeroed = gate_hard_losses({k: torch.tensor(1.0) for k in keys}, cfg)
    assert all(float(v) == 0.0 for v in zeroed.values())


# ----------------------------------------------------------- port alone
def test_dropout_masks_keep_rate_and_scale():
    """A layer's masks: the keep rate within 3 sigma of 0.9, kept entries
    scaled by 1/0.9, the same (seed, layer) the same masks, another layer
    others."""
    x = torch.ones(200_000)
    y = _Dropout(0.1, 12345, 3, x.device)(x)
    kept = y != 0
    rate = float(kept.float().mean())
    sigma = (0.9 * 0.1 / x.numel()) ** 0.5
    print(f"keep rate {rate:.5f}, 3 sigma {3 * sigma:.5f}")
    assert abs(rate - 0.9) <= 3 * sigma
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert torch.equal(_Dropout(0.1, 12345, 3, x.device)(x), y)
    assert not torch.equal(_Dropout(0.1, 12345, 4, x.device)(x), y)
    assert _Dropout(0.1, None, 3, x.device)(x) is x


def port_step_with(cfg, weights, batch, draws):
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, weights)
    state, m = make_train_step(cfg, det)(state, batch, draws)
    return {k: float(v) for k, v in m.items()}, params_of(state.student)


def test_dropout_draws_make_the_step_deterministic():
    """With DROPOUT 0.1 each student stream takes one seed from
    ``draw_step``: the same draws give the same step twice (and with
    USE_ACT_CHECKPOINT, whose recompute rebuilds the same masks), other
    draws another step."""
    cfg = step_cfg(port_get_cfg, **{
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.DROPOUT": 0.1})
    det = build_detector(cfg, device="cpu", seed=3)
    weights = det.module.state_dict()
    batch = _tree(make_batch(seed=2), torch.from_numpy)
    draws = draw_step(torch.Generator().manual_seed(5), det, 2, 2)
    assert isinstance(draws["strong"]["dropout"], int)
    assert isinstance(draws["distill"]["dropout"], int)
    m1, p1 = port_step_with(cfg, weights, batch, draws)
    m2, p2 = port_step_with(cfg, weights, batch, draws)
    assert m1 == m2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    ckpt = step_cfg(port_get_cfg, **{
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.DROPOUT": 0.1,
        "MODEL.DEFORMABLE_DETR.USE_ACT_CHECKPOINT": True})
    m3, p3 = port_step_with(ckpt, weights, batch, draws)
    assert m3 == m1
    assert all(torch.equal(p1[k], p3[k]) for k in p1)
    other = dict(draws, strong={"dropout": draws["strong"]["dropout"] + 1})
    m4, _ = port_step_with(cfg, weights, batch, other)
    assert m4["loss_ce_source_strong"] != m1["loss_ce_source_strong"]
    assert m4["loss_ce_distill"] == m1["loss_ce_distill"]


def test_alignment_is_a_pass_through():
    """With DOMAIN_ADAPT.ALIGN on, DETR's target_weak stream has no loss
    (the reference's ``DETRAlignMixin``, ``aldi_tpu/models/detr.py:795``):
    the step runs, with the same losses as without it."""
    det = build_detector(step_cfg(port_get_cfg), device="cpu", seed=2)
    weights = det.module.state_dict()
    batch = _tree(make_batch(seed=1), torch.from_numpy)
    draws = draw_step(torch.Generator().manual_seed(4), det, 2, 2)
    want, _ = port_step_with(step_cfg(port_get_cfg), weights, batch, draws)
    for at_end in (False, True):
        got, _ = port_step_with(step_cfg(port_get_cfg, **{
            "DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
            "SOLVER.BACKWARD_AT_END": at_end}), weights, batch, draws)
        assert got == want


def test_grad_accum_2_equals_each_chunk_alone():
    """TPU.GRAD_ACCUM 2 on 2 + 2 images: the losses are the mean of each
    chunk's (1 + 1 images) step alone (1e-5 relative) and the summed
    gradient is the mean of theirs (clipping off so the gradients stay as
    computed): 1e-5 of each tensor's scale outside the R50, 2e-2 inside.
    The strong views of a chunk alone differ from the whole batch's in the
    last bits (1.5e-5 of 255: the blur's convolution runs on another
    batch), and the R50's gradient amplifies that to 8e-3 of its scale
    (measured; without the erasing, or without the distill stream, both
    agree to 1e-6)."""
    over = {"SOLVER.CLIP_GRADIENTS.ENABLED": False}
    cfg1 = step_cfg(port_get_cfg, **over)
    cfg2 = step_cfg(port_get_cfg, **{**over, "TPU.GRAD_ACCUM": 2})
    det = build_detector(cfg1, device="cpu", seed=4)
    weights = det.module.state_dict()
    batch = _tree(make_batch(seed=3), torch.from_numpy)
    draws = draw_step(torch.Generator().manual_seed(6), det, 2, 2)

    def run(cfg, batch, draws):
        d = build_detector(cfg, device="cpu")
        state = create_train_state(cfg, d, weights)
        _, m = make_train_step(cfg, d)(state, batch, draws)
        return ({k: float(v) for k, v in m.items()},
                {k: p.grad.clone() for k, p in state.student.named_parameters()
                 if p.grad is not None})

    # the same strong views; each chunk's dropout seed unused at DROPOUT 0
    draws2 = {**draws, "strong": [draws["strong"]] * 2,
              "distill": [draws["distill"]] * 2}
    m_acc, g_acc = run(cfg2, batch, draws2)
    chunks = []
    for c in range(2):
        sl = slice(c, c + 1)
        chunk = {s: {k: v[sl] for k, v in d.items()}
                 for s, d in batch.items()}
        d = {k: {kk: vv[sl] for kk, vv in v.items()}
             for k, v in draws.items() if k.startswith("aug_")}
        chunks.append(run(cfg1, chunk, d))
    for k, v in m_acc.items():
        if k == "num_pseudo_labels":
            continue
        mean = (chunks[0][0][k] + chunks[1][0][k]) / 2
        assert v == pytest.approx(mean, rel=1e-5, abs=1e-6), k
    assert set(g_acc) == set(chunks[0][1])
    worst = {}
    for k, g in g_acc.items():
        mean = (chunks[0][1][k] + chunks[1][1][k]) / 2
        part = "R50" if k.startswith("backbone.") else "rest"
        err = float((g - mean).abs().max() / mean.abs().max())
        worst[part] = max(worst.get(part, 0.0), err)
    print(f"gradient max err / scale: {worst}")
    assert worst["rest"] <= 1e-5 and worst["R50"] <= 2e-2


def test_adamw_multipliers_match_optax():
    """DETR's ADAMW (``aldi_tpu/solver.py:184-202``: the R50 x0.1,
    ``sampling_offsets`` and ``reference_points`` x0.1, the frozen stem and
    res2 untouched) against optax's ``scale_updates_by_tree`` on two steps
    of random gradients. float32, rtol 1e-5 (atol 1e-8)."""
    over = {"SOLVER.CLIP_GRADIENTS.ENABLED": False}
    jcfg, tcfg = step_cfg(jax_get_cfg, **over), step_cfg(port_get_cfg, **over)
    variables = _np(detr_variables(jax_build_detector(jcfg), seed=2))
    params = _tree(variables["params"], jnp.asarray)
    rng = np.random.default_rng(4)

    def grad(path, p):  # the frozen stem and res2 get none, as in a step
        names = [k.key for k in path]
        frozen = names[0] == "backbone" and names[1].startswith(
            ("stem", "res2_"))
        return (rng.standard_normal(p.shape) * 0.1 * (not frozen)).astype(
            np.float32)

    grads = [jax.tree_util.tree_map_with_path(grad, variables["params"])
             for _ in range(2)]
    tx = jax_build_optimizer(jcfg, params)
    opt_state = tx.init(params)

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for g in grads:
        params, opt_state = update(_tree(g, jnp.asarray), opt_state, params)
    want = jax_variables_to_state_dict({"params": _np(params)})
    before = jax_variables_to_state_dict({"params": variables["params"]})

    module = build_detector(tcfg, device="cpu").module
    module.load_state_dict(jax_variables_to_state_dict(variables))
    opt = build_optimizer(tcfg, module)
    assert sorted({g["lr_mult"] for g in opt.param_groups}) == [0.1, 1.0]
    named = dict(module.named_parameters())
    for step, g in enumerate(grads):
        for k, v in jax_variables_to_state_dict({"params": g}).items():
            named[k].grad = v
        set_lr(opt, tcfg.SOLVER.BASE_LR)  # WARMUP_ITERS 0
        opt.step()
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    moved = {k: float((named[k].detach() - before[k]).abs().max())
             for k in ("backbone.0.body.conv1.weight",
                       "backbone.0.body.layer2.0.conv1.weight",
                       "transformer.reference_points.weight",
                       "transformer.encoder.layers.0.self_attn."
                       "sampling_offsets.weight",
                       "transformer.encoder.layers.0.linear1.weight")}
    print(f"largest move per parameter: {moved}")
    lr = tcfg.SOLVER.BASE_LR
    assert moved["backbone.0.body.conv1.weight"] == 0.0
    for k, v in moved.items():
        if k != "backbone.0.body.conv1.weight":
            want_mult = 1.0 if "linear1" in k else 0.1
            assert 0.5 * want_mult * lr < v < 2.5 * want_mult * lr, k


# ------------------------------------------------- trainer and artifact
def trainer_opts(names, out, max_iter, **overrides):
    """``train_net`` overrides: the tiny ALDI-Best-DETR recipe on the
    synthetic datasets, 2 + 2 images per step, a checkpoint every 2
    iterations."""
    cfg = loader_cfg(step_cfg(port_get_cfg), names)
    t = cfg.MODEL.DEFORMABLE_DETR.TRANSFORMER
    over = {
        "MODEL.DEVICE": "cpu", "MODEL.WEIGHTS": "", "OUTPUT_DIR": str(out),
        "MODEL.DEFORMABLE_DETR.NUM_CLASSES": 3,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.ENC_LAYERS": t.ENC_LAYERS,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.DEC_LAYERS": t.DEC_LAYERS,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.NUM_QUERIES": t.NUM_QUERIES,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.HIDDEN_DIM": t.HIDDEN_DIM,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.DIM_FEEDFORWARD":
            t.DIM_FEEDFORWARD,
        "MODEL.DEFORMABLE_DETR.TRANSFORMER.NHEADS": t.NHEADS,
        "TPU.CANVAS": (128, 128), "TPU.MAX_GT": 8, "TPU.DATA_THREADS": 2,
        "INPUT.MIN_SIZE_TRAIN": cfg.INPUT.MIN_SIZE_TRAIN,
        "INPUT.MAX_SIZE_TRAIN": cfg.INPUT.MAX_SIZE_TRAIN,
        "INPUT.MIN_SIZE_TEST": cfg.INPUT.MIN_SIZE_TEST,
        "INPUT.MAX_SIZE_TEST": cfg.INPUT.MAX_SIZE_TEST,
        "DATASETS.TRAIN": cfg.DATASETS.TRAIN,
        "DATASETS.UNLABELED": cfg.DATASETS.UNLABELED,
        "DATASETS.TEST": cfg.DATASETS.TEST,
        "SOLVER.IMS_PER_BATCH": 4, "SOLVER.MAX_ITER": max_iter,
        "SOLVER.CHECKPOINT_PERIOD": 2, "SOLVER.WARMUP_ITERS": 0,
        "TEST.EVAL_PERIOD": 0, "TEST.DETECTIONS_PER_IMAGE": 10,
        "VIS_PERIOD": 0, "SEED": 7, **STEP, **overrides}
    return [x for k, v in over.items() for x in (k, str(v))]


def test_train_net_saves_resumes_and_evaluates(tmp_path, no_tensorboard):
    """``train_net`` on the ALDI-Best-DETR YAML: 2 iterations with a
    checkpoint (the YAML's absolute_range crop on), ``--resume`` to 4 from
    the saved student, teacher and optimizer, equal bit for bit to 4
    straight iterations; then ``--eval-only --resume``."""
    names = register_synthetic_both(tmp_path / "data", "port_detr_trainer")
    config = "configs/cityscapes/ALDI-Best-DETR-Cityscapes.yaml"
    parser = train_net.default_argument_parser()
    try:
        resumed = tmp_path / "resumed"
        train_net.main(parser.parse_args(
            ["--config-file", config] + trainer_opts(names, resumed, 2)))
        ckpt = torch.load(resumed / "model_0000002.pth", weights_only=True)
        assert ckpt["iteration"] == 2 and "query_embed.weight" in ckpt["model"]
        train_net.main(parser.parse_args(
            ["--config-file", config, "--resume"]
            + trainer_opts(names, resumed, 4)))
        straight = tmp_path / "straight"
        train_net.main(parser.parse_args(
            ["--config-file", config] + trainer_opts(names, straight, 4)))
        a = torch.load(resumed / "model_0000004.pth", weights_only=True)
        b = torch.load(straight / "model_0000004.pth", weights_only=True)
        for entry in ("model", "ema"):
            for k, v in a[entry].items():
                assert torch.equal(v, b[entry][k]), (entry, k)
        with open(resumed / "metrics.json") as f:
            lines = [json.loads(x) for x in f]
        assert {"loss_ce_distill", "loss_giou_source_strong"} <= set(
            lines[-1])
        results = train_net.main(parser.parse_args(
            ["--config-file", config, "--eval-only", "--resume"]
            + trainer_opts(names, resumed, 4)))
        ap = results[names["val"]]["bbox/AP50"]
        print(f"AP50 of the teacher after 4 iterations: {ap}")
        assert np.isfinite(ap)
    finally:
        drop_weight_files(tmp_path)


def test_artifact_round_trip_is_bitwise_eager(tmp_path):
    """The tiny DETR exported for the CPU, saved and loaded: the program
    serves bitwise what the eager path does, its graph calls no kernel op
    (K4 is training-only) and ``meta.json`` names the architecture."""
    cfg = step_cfg(port_get_cfg)
    det = build_detector(cfg, device="cpu", seed=1)
    programs = export_inference(det, None, 2, platforms=("cpu",))
    ops = [str(n.target) for n in programs["cpu"].graph.nodes
           if n.op == "call_function"]
    assert not any(op.startswith("aldi_tpu_torch.") for op in ops)
    save_artifact(str(tmp_path), programs, det, cfg, 2)
    model = load_artifact(str(tmp_path), platform="cpu")
    assert model.meta["meta_architecture"] == "DeformableDETR"
    batch = _tree(make_batch(seed=4), torch.from_numpy)
    images, sizes = batch["unlabeled"]["image"], batch["unlabeled"]["sizes"]
    got = model(images, sizes)
    want = make_serving_fn(det)(images, sizes)
    assert int(want["valid"].sum()) == 2 * cfg.TEST.DETECTIONS_PER_IMAGE
    for k in want:
        assert torch.equal(got[k], want[k]), k
