"""Data-parallel YOLOv5 of the port at world size 2, on the CPU: sync-BN
(``models/yolo.py`` ``_BatchNormTrain`` all-reduces its statistics and
their gradients' sums) and the global denominators of YOLO's losses. Two
spawned gloo ranks (``tests/torch_port_dist.py``) step on their shares of
a global batch of 4 + 4 images, against the port's world-1 step on the
whole batch and the JAX package's step on a 2-device data mesh, whose
flax BatchNorm normalizes by the global batch's statistics
(``docs/DIVERGENCES.md``: sync-BN).

The config is ``tests/test_torch_port_yolo_train.py``'s (the ALDI-Yolo
recipe cut to yolov5n, 3 classes, canvas 128, float32, EMA.ALPHA 0.9,
TEACHER.THRESHOLD 0.1) over the uneven global batch of
``tests/test_torch_port_ddp.py`` (3, 4, 5 and 6 gt boxes). The seeded
teacher scores every candidate within 0.262-0.266, so each unlabeled image
gets MAX_GT pseudo-labels; the ranks' shares of the distill stream's
denominators (the candidate cells of those boxes) differ all the same, as
the labeled stream's do. Two steps, each: the losses, the student's and
the teacher's parameters and BatchNorm running statistics.

Tolerances, for world 2 against world 1 as for both against the JAX mesh,
those of ``tests/test_torch_port_yolo_train.py``: losses 1e-4 relative,
parameters and running statistics 1e-4 of each tensor's scale, the
student's parameters after the second step 5e-4. World 2 sums the
statistics and the losses in another order; the first step's parameters
differ by 6.7e-6 of the scale and its statistics by 1.3e-6, and the second
step's gradient, taken at parameters that already differ by that
rounding, moves the student's parameters by 1.6e-4 (the 60 layers amplify
it, as the JAX comparison finds). The two ranks' parameters and running
statistics are bitwise equal.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from aldi_tpu.config import get_cfg as jax_get_cfg
from aldi_tpu.engine import make_train_step as jax_make_train_step
from aldi_tpu.engine.train_step import TrainState as JaxTrainState
from aldi_tpu.models import build_detector as jax_build_detector
from aldi_tpu.parallel.mesh import make_mesh, replicate
from aldi_tpu.parallel.mesh import shard_batch as jax_shard_batch
from aldi_tpu.solver import build_optimizer as jax_build_optimizer
from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from tests import torch_port_dist as dist_run
from tests.test_torch_port_ddp import check_metrics, global_batch, rank_sums
from tests.test_torch_port_yolo_train import (_np, _tree, scaled_err,
                                              step_cfg, step_draws)
from tests.torch_port_common import yolo_variables
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 runs on one thread, as each spawned rank."""
    with torch_threads(1):
        yield


def jax_mesh_steps(cfg, variables, batches, rngs, n_devices=2):
    """The JAX package's jitted YOLO step on an n-device data mesh: per
    step the metrics, the student and the teacher (parameters and
    BatchNorm statistics) as port state dicts."""
    jdet = jax_build_detector(cfg)
    params = _tree(variables["params"], jnp.asarray)
    tx = jax_build_optimizer(cfg, params)
    stats = _tree(variables["batch_stats"], jnp.asarray)
    state = JaxTrainState(
        step=jnp.asarray(0, jnp.int32), params=params, frozen={},
        opt_state=tx.init(params),
        ema_params=_tree(variables["params"], jnp.asarray),
        model_state={"batch_stats": stats},
        ema_model_state={"batch_stats": _tree(variables["batch_stats"],
                                              jnp.asarray)})
    data = make_mesh(n_devices)
    state = replicate(state, data)
    step = jax_make_train_step(cfg, jdet, tx)
    out = []
    for batch, rng in zip(batches, rngs):
        state, m = step(state, jax_shard_batch(_tree(batch, jnp.asarray),
                                               data), rng)
        out.append(({k: float(v) for k, v in m.items()},
                    jax_variables_to_state_dict(_np({
                        "params": state.params, **state.model_state})),
                    jax_variables_to_state_dict(_np({
                        "params": state.ema_params,
                        **state.ema_model_state}))))
    return out


def check_states(got, want, tol, what, second_tol=None):
    """Per step and for the student and the teacher: the parameters and the
    running statistics, each tensor to ``tol`` of its scale (the student's
    parameters after the second step to ``second_tol``)."""
    for i, ((gs, gt), (ws, wt)) in enumerate(zip(got, want)):
        for who, g, w in (("student", gs, ws), ("teacher", gt, wt)):
            assert set(g) == set(w)
            for kind in ("parameters", "running statistics"):
                names = [k for k in w if k.endswith(
                    ("running_mean", "running_var")) == (kind != "parameters")]
                worst = max(scaled_err(g[k], w[k]) for k in names)
                t = (second_tol if second_tol and i == 1
                     and who == "student" and kind == "parameters" else tol)
                print(f"{what}, step {i + 1} {who} {kind}: worst max err / "
                      f"scale {worst:.3g} (tol {t})")
                assert worst <= t, (what, i, who, kind)


def test_yolo_world2_equals_world1_and_the_jax_mesh(tmp_path):
    jcfg = step_cfg(jax_get_cfg)
    tcfg = step_cfg(port_get_cfg)
    variables = _np(yolo_variables(jax_build_detector(jcfg), seed=5))
    weights = jax_variables_to_state_dict(variables)
    batches = [global_batch(seed) for seed in (0, 1)]
    rngs = [jax.random.PRNGKey(s) for s in (41, 42)]
    draws = [step_draws(r, tcfg, 4) for r in rngs]
    tb = [_tree(b, torch.from_numpy) for b in batches]
    cfg_dict = dist_run.portable(tcfg)
    # the port at world 1 and at world 2, each step's states
    w1_m, w1_s, w1_t = dist_run.daod_steps(0, 1, cfg_dict, weights, tb, draws,
                                           every_step=True)
    (m0, s0, t0), (m1, s1, t1) = dist_run.run_ranks(
        dist_run.daod_steps, 2, tmp_path, cfg_dict, weights, tb, draws, 1,
        True)
    for a, b in zip(s0 + t0, s1 + t1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert min(m[0]["num_pseudo_labels"] for m in (m0, m1)) > 0
    got = list(zip(s0, t0))
    check_metrics(rank_sums([m0, m1]), w1_m, 1e-4, "world 2 vs world 1")
    check_states(got, list(zip(w1_s, w1_t)), 1e-4, "world 2 vs world 1",
                 second_tol=5e-4)
    want = jax_mesh_steps(jcfg, variables, batches, rngs)
    check_metrics(rank_sums([m0, m1]), [w[0] for w in want], 1e-4,
                  "world 2 vs JAX mesh")
    check_states(got, [(w[1], w[2]) for w in want], 1e-4,
                 "world 2 vs JAX mesh", second_tol=5e-4)
    name = "b0.bn.running_var"
    start = weights[name]
    assert not torch.equal(got[0][0][name], start)
    assert not torch.equal(got[1][0][name], got[0][0][name])
