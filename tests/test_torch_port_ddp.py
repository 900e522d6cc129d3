"""Data-parallel training of the port (``aldi_tpu_torch/parallel/mesh.py``)
at world size 2, on the CPU: two spawned processes in a gloo group
(``tests/torch_port_dist.py``), each stepping on its share of a global
batch of 4 + 4 images, against the port's world-1 step on the whole batch
and against the JAX package's step on a 2-device data mesh
(``make_mesh(2)``, the state replicated, the batch sharded, as
``__graft_entry__.py`` ``_run_sharded_step`` runs it).

The config is the tiny flagship of ``tests/test_torch_port_train_step.py``
(ResNet-26, canvas 128, 3 classes, float32, saturated sampling) with soft
distillation and both discriminators (``DOMAIN_ADAPT.ALIGN``'s image and
instance level, 33 ROIs per image as ``tests/test_torch_port_align.py``
takes them), at TPU.GRAD_ACCUM 1 and 2. The global batch splits unevenly:
the labeled images carry 3, 4, 5 and 6 gt boxes and the ranks' teachers
find different numbers of pseudo-labels, so a denominator that a rank
decided alone would show.

The JAX mesh runs at TPU.GRAD_ACCUM 2 only, the harder map (its
``lax.scan`` over the sharded global batch): one JAX compile for the file.

Tolerances. Against the JAX mesh, those with which
``tests/test_torch_port_align.py`` holds the world-1 step: losses 1e-4
relative, parameters after two steps 1e-5 absolute (lr 0.01). World 2
against world 1: losses 1e-4 relative, parameters 1e-4. World 2 sums the
same terms in another order (the ranks' partial sums; convolutions over 1
or 2 images instead of 4), and a near-tie of the second step's samplers
flips with those last bits: the parameters differed by 3e-8, 2.7e-6 and
2.2e-5 with the world-1 run on 4, 2 and 1 threads (each process here runs
on one), while the student moves by 0.02; the second step's losses by up
to 1.1e-5 relative. A denominator left to a rank would be off by a factor
near 2. The two ranks' parameters are bitwise equal (the all-reduce gives
both the same sums).
"""

import datetime
import time

import jax
import numpy as np
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import create_train_state as jax_create_train_state
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.parallel.mesh import make_mesh, replicate
from aldi_tpu.parallel.mesh import shard_batch as jax_shard_batch
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from aldi_tpu_torch.models import build_detector
from aldi_tpu_torch.parallel import mesh
from tests import torch_port_dist as dist_run
from tests import torch_port_draws as draws_from
from tests.test_torch_port_train_step import daod_cfg, jax_tree, torch_tree
from tests.torch_port_common import max_err, seeded_variables
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

ALIGNED = {"DOMAIN_ADAPT.ALIGN.IMG_DA_ENABLED": True,
           "DOMAIN_ADAPT.ALIGN.INS_DA_ENABLED": True,
           "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 33}
# the seeded weights' teacher finds 5, 3, 6 and 5 pseudo-labels on the
# first batch's unlabeled images at TEACHER.THRESHOLD 0.5; with these
# seeds no pseudo-label box sits where a one-ulp difference (the JAX
# mesh's sharded convolutions) breaks a low-quality tie (ROADMAP.md,
# faults: the reference shares that limit)
WEIGHTS_SEED = 6
SIZES = np.array([[128, 128], [112, 120], [120, 104], [96, 128]], np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 runs on one thread, as each spawned rank."""
    with torch_threads(1):
        yield


def global_batch(seed, b=4, max_gt=8):
    """4 labeled images with 3, 4, 5 and 6 gt boxes, 4 unlabeled ones."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        for g in range(3 + i):
            x0, y0 = rng.uniform(0, 70, 2)
            w, h = rng.uniform(12, 48, 2)
            boxes[i, g] = [x0, y0, x0 + w, y0 + h]
            classes[i, g] = rng.integers(0, 3)
            valid[i, g] = True
    return {
        "labeled": {
            "image": rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32),
            "sizes": SIZES[:b], "boxes": boxes, "classes": classes,
            "valid": valid},
        "unlabeled": {
            "image": rng.uniform(0, 255, (b, 128, 128, 3)).astype(np.float32),
            "sizes": SIZES[::-1][:b].copy()},
    }


def rank_sums(per_rank):
    """The ranks' metric shares summed, per step."""
    return [{k: sum(m[k] for m in step) for k in step[0]}
            for step in zip(*per_rank)]


def check_metrics(got, want, rtol, what):
    """Per step, every metric of ``got`` against ``want``, relative."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), set(g) ^ set(w)
        errs = {k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-3) for k in w}
        worst = max(errs, key=errs.get)
        print(f"{what}, step {i + 1}: losses, worst relative error "
              f"{errs[worst]:.3g} ({worst}; tol {rtol})")
        assert errs[worst] <= rtol, (what, i, worst, g[worst], w[worst])


def check_params(got, want, atol, what):
    err = max(max_err(got[k].numpy(), w.numpy()) for k, w in want.items())
    print(f"{what}: max abs err {err:.3g} (tol {atol})")
    assert err <= atol, what


def jax_mesh_steps(cfg, variables, batches, rngs, n_devices=2):
    """The JAX package's jitted step on an n-device data mesh: per step
    the metrics, and the student's and teacher's parameters after the
    last step as port state dicts."""
    jdet = jax_build_detector(cfg)
    state, tx = jax_create_train_state(cfg, jdet, jax.random.PRNGKey(0))
    params = jax_tree(dict(variables["params"]))
    state = state.replace(params=params,
                          frozen=jax_tree(dict(variables["frozen"])),
                          opt_state=tx.init(params),
                          ema_params=jax_tree(dict(variables["params"])))
    data = make_mesh(n_devices)
    state = replicate(state, data)
    step = jax_make_train_step(cfg, jdet, tx)
    metrics = []
    for batch, rng in zip(batches, rngs):
        state, m = step(state, jax_shard_batch(jax_tree(batch), data), rng)
        metrics.append({k: float(v) for k, v in m.items()})

    def sd(tree):
        return jax_variables_to_state_dict(
            {"params": jax.tree_util.tree_map(np.asarray, tree)})

    return metrics, sd(state.params), sd(state.ema_params)


def setup(accum):
    over = {**ALIGNED, "TPU.GRAD_ACCUM": accum}
    jcfg = daod_cfg(jax_get_cfg, saturated=True, **over)
    tcfg = daod_cfg(port_get_cfg, saturated=True, **over)
    variables = seeded_variables(jax_build_detector(jcfg),
                                 seed=WEIGHTS_SEED)
    batches = [global_batch(seed) for seed in (2, 3)]
    rngs = [jax.random.PRNGKey(s) for s in (41, 42)]
    return jcfg, tcfg, variables, batches, rngs


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """``run(k)``: two steps of the aligned DAOD recipe at TPU.GRAD_ACCUM
    k, the port's at world 1 and its two ranks', made once per k."""
    runs = {}

    def run(accum):
        if accum not in runs:
            _, tcfg, variables, batches, rngs = setup(accum)
            weights = jax_variables_to_state_dict(variables)
            n_anchors = build_detector(tcfg, device="cpu").anchors_cat.shape[0]
            draws = [draws_from.train_step_draws(r, tcfg, 4, 4, n_anchors)
                     for r in rngs]
            tb = [torch_tree(b) for b in batches]
            cfg_dict = dist_run.portable(tcfg)
            world1 = dist_run.daod_steps(0, 1, cfg_dict, weights, tb, draws,
                                         accum)
            ranks = dist_run.run_ranks(
                dist_run.daod_steps, 2, tmp_path_factory.mktemp("ddp"),
                cfg_dict, weights, tb, draws, accum)
            runs[accum] = world1, ranks, weights
        return runs[accum]

    return run


@pytest.fixture(scope="module")
def jax_mesh_accum2():
    jcfg, _, variables, batches, rngs = setup(2)
    return jax_mesh_steps(jcfg, variables, batches, rngs)


@pytest.mark.parametrize("accum", [1, 2])
def test_world2_equals_world1_on_the_global_batch(port_runs, accum):
    """The ranks' summed losses and their parameters after two steps are
    the world-1 step's on the concatenated batch; both ranks hold the same
    parameters, and their shares of the pseudo-labels differ."""
    (w1_m, w1_s, w1_t), ranks, start = port_runs(accum)
    (m0, s0, t0), (m1, s1, t1) = ranks
    for a, b in ((s0, s1), (t0, t1)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert {f"loss_da_{k}_{s}" for k in ("img", "ins")
            for s in ("source_strong", "target_weak")} <= set(m0[0])
    shares = [m[0]["num_pseudo_labels"] for m in (m0, m1)]
    print(f"num_pseudo_labels shares of the ranks: {shares}")
    assert shares[0] != shares[1] and min(shares) > 0
    check_metrics(rank_sums([m0, m1]), w1_m, 1e-4, "world 2 vs world 1")
    moved = max(max_err(w1_s[k].numpy(), start[k].numpy()) for k in start)
    print(f"the student's largest move: {moved:.3g}")
    assert moved >= 100 * 1e-4
    check_params(s0, w1_s, 1e-4, "world 2 vs world 1, student")
    check_params(t0, w1_t, 1e-4, "world 2 vs world 1, teacher")


def test_world2_equals_the_jax_2_device_mesh(port_runs, jax_mesh_accum2):
    """At TPU.GRAD_ACCUM 2: the ranks' summed losses and their parameters
    after two steps are the JAX package's on its 2-device mesh."""
    (j_m, j_s, j_t), (_, ranks, _) = jax_mesh_accum2, port_runs(2)
    (m0, s0, t0), (m1, _, _) = ranks
    assert j_m[0]["num_pseudo_labels"] > 0
    check_metrics(rank_sums([m0, m1]), j_m, 1e-4, "world 2 vs JAX mesh")
    check_params(s0, {k: v for k, v in j_s.items()}, 1e-5,
                 "world 2 vs JAX mesh, student")
    check_params(t0, {k: v for k, v in j_t.items()}, 1e-5,
                 "world 2 vs JAX mesh, teacher")


def test_shard_positions_follow_the_chunks():
    """Rank r holds, for each TPU.GRAD_ACCUM chunk of the global batch,
    its contiguous 1/W: the map under which chunk c is the JAX scan's."""
    assert mesh.shard_positions(8, 1, 0, 2).tolist() == [0, 1, 2, 3]
    assert mesh.shard_positions(8, 1, 1, 2).tolist() == [4, 5, 6, 7]
    assert mesh.shard_positions(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert mesh.shard_positions(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    assert mesh.shard_positions(8, 4, 1, 2).tolist() == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_positions(6, 2, 0, 2)


def test_reductions_at_world2(tmp_path):
    """Each reduction of ``parallel/mesh.py`` on two gloo ranks: counts and
    metrics summed, the batch mean shared, the gradients summed through
    several buckets, rank 0's weights broadcast to rank 1."""
    r0, r1 = dist_run.run_ranks(dist_run.collectives, 2, tmp_path)
    x0, x1 = torch.arange(4.0), torch.arange(4.0) * 2
    assert torch.equal(r0["mean"] + r1["mean"], torch.cat([x0, x1]).mean())
    for r in (r0, r1):
        assert torch.equal(r["count"], x0 + x1)
        assert {k: float(v) for k, v in r["metrics"].items()} == {
            "a": 18.0, "b": 0.0}
        assert r["buckets"] == 2 and r["bytes"] == 4 * (6 + 2)
        assert torch.equal(r["grads"][0], torch.full((2, 3), 3.0))
        assert torch.equal(r["grads"][1], torch.full((2,), 30.0))
        assert r["global_batch"] == 6 and r["all_reduce_grads"] == 32
        assert all(torch.equal(v, torch.ones_like(v))
                   for v in r["state"].values())


@pytest.mark.parametrize("peer", ["leaves", "waits"])
def test_a_rank_conditional_loss_fails_instead_of_hanging(tmp_path, peer):
    """A loss's global denominator is an all-reduce that every rank must
    make: when rank 0 alone makes it, the run raises (the peer gone, or the
    group's 5 s timeout) well before the 180 s deadline, which would raise
    a TimeoutError instead."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        dist_run.run_ranks(dist_run.rank_conditional_loss, 2, tmp_path,
                           peer, timeout=180,
                           group_timeout=datetime.timedelta(seconds=5))
    print(f"peer {peer}: raised after {time.monotonic() - t0:.1f} s: "
          f"{str(err.value).splitlines()[0]}")
    assert str(err.value).startswith("process ")  # a rank's own error


def test_without_a_group_the_reductions_are_the_identity():
    """No group: world 1, and every reduction returns its input itself."""
    assert not mesh.is_initialized()
    assert (mesh.rank(), mesh.world(), mesh.global_batch(3)) == (0, 1, 3)
    x = torch.arange(5.0)
    assert mesh.global_count(x) is x
    assert torch.equal(mesh.batch_mean(x), x.mean())
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    g = p.grad
    assert mesh.all_reduce_grads([p]) == 0 and p.grad is g
    assert torch.equal(g, torch.full((3,), 2.0))
    metrics = {"a": x.sum()}
    assert mesh.reduce_metrics(metrics) is metrics
    draws = {"strong": {"rpn": {"tie": x}}}
    assert mesh.shard_draws(draws) is draws


@pytest.mark.parametrize("key,value", [("TPU.MESH_MODEL", 2),
                                       ("TPU.FSDP", True)])
def test_model_sharding_still_raises(key, value):
    """The grid's check (``mesh.check_grid``) on a group the settings do
    not fit: without a group (world 1) TPU.MESH_MODEL 2 raises the JAX
    package's ``make_mesh`` error, and TPU.FSDP with a TPU.MESH_DATA of 2
    raises, while TPU.FSDP alone fits world 1."""
    cfg = daod_cfg(port_get_cfg, **{key: value})
    if key == "TPU.FSDP":
        mesh.check_grid(cfg)
        cfg = daod_cfg(port_get_cfg, **{key: value, "TPU.MESH_DATA": 2})
    with pytest.raises(ValueError, match="devices not divisible|MESH_DATA"):
        mesh.check_grid(cfg)
