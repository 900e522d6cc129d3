"""FSDP of the port (``aldi_tpu_torch/parallel/fsdp.py``, ``TPU.FSDP``) on
the data x model grid, on the CPU: gloo ranks spawned through
``tests/torch_port_dist.py`` running ``tests/torch_port_grid.py``.

``tests/test_torch_port_tp.py``'s burn-in step (the tiny config of
``tests/test_tensor_parallel.py``, batch 8) with TPU.FSDP:

- at D = 2 (W = 2): against the port's world-1 step and the JAX package's
  ``shard_state(..., fsdp=True)`` step; each rank holds half of every
  chosen leaf's parameter, SGD momentum and EMA teacher (counted in
  elements and bytes);
- composed with the model axis at D = 2 x M = 2 (W = 4): the box head's
  ``fc1`` keeps its tensor-parallel split (the rule's priority) and the
  step matches world 1 and JAX's ``test_fsdp_composes_with_tp`` step (the
  JAX package's 4x2 mesh with ``fsdp=True``, the one JAX compile of the
  file, to which the D = 2 step is held too: the same math);
- with ADAMW at D = 2: both moments held in halves, gathered into world
  1's.

Tolerances: losses 1e-5 relative and parameters 1e-4, as the JAX test
holds its FSDP step against DP (the student moves by 1.5e-2); ADAMW's
moments 1e-5 of each tensor's largest magnitude. Measured: at D = 2
losses 1.2e-7 and parameters 1.5e-8 against world 1, 8.3e-8 and 3.0e-8
against JAX; at 2 x 2, 1.2e-7 and 1.5e-8, 1.6e-7 and 3.0e-8; the moments
8.4e-7 and 1.5e-6. The planted fault, FSDP's gradients averaged instead of
summed, moves the parameters by 3.2e-3.
"""

import pytest

from aldi_tpu_torch.config import get_cfg as port_get_cfg
from aldi_tpu_torch.engine.checkpoint_convert import jax_variables_to_state_dict
from tests import torch_port_dist as dist_run
from tests import torch_port_grid as grid
from tests.test_torch_port_tp import (LOSS_RTOL, PARAM_ATOL, burnin_cfg,
                                      burnin_setup, jax_mesh_step, loss_err,
                                      param_err, port_draws, summed)
from tests.test_torch_port_train_step import torch_tree
from tests.torch_port_threads import capped_torch_threads  # noqa: F401
from tests.torch_port_threads import torch_threads

MOMENT_RTOL = 1e-5  # of each moment tensor's largest magnitude
FSDP = {"TPU.FSDP": True}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's world-1 runs on one thread, as each spawned rank."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The burn-in step with TPU.FSDP at world 1 and on the grid: D = 2
    (clean and with FSDP averaging planted), D = 2 x M = 2, and ADAMW at
    world 1 and D = 2."""
    _, _, variables, batch, rng = burnin_setup()
    weights = jax_variables_to_state_dict(variables)
    tmp = tmp_path_factory.mktemp("fsdp")
    out = {"weights": weights}
    for opt in ("SGD", "ADAMW"):
        tcfg = burnin_cfg(port_get_cfg, **FSDP, **{"SOLVER.OPTIMIZER": opt})
        batches, draws = [torch_tree(batch)], [port_draws(tcfg, rng, 8)]
        cfg = dist_run.portable(tcfg)
        out[opt, 1] = grid.steps(cfg, weights, batches, draws)
        grids = ({(2, 1): (None, "fsdp averaged"), (4, 2): (None,)}
                 if opt == "SGD" else {(2, 1): (None,)})
        for (w, m), faults in grids.items():
            out[opt, w] = dist_run.run_ranks(grid.grid_steps, w, tmp, m, cfg,
                                             weights, batches, draws, faults)
    return out


@pytest.fixture(scope="module")
def jax_fsdp_tp():
    jcfg, _, variables, batch, rng = burnin_setup()
    return jax_mesh_step(jcfg, variables, batch, rng, model_parallel=2,
                         fsdp_=True)


def chosen(ranks):
    return {n: s for n, s in ranks[0][0]["bytes"]["shards"].items()
            if s[0] == "data"}


@pytest.mark.parametrize("w", [2, 4])
def test_fsdp_step_equals_world1_and_the_jax_mesh(runs, jax_fsdp_tp, w):
    """D = 2 (W = 2) and D = 2 x M = 2 (W = 4): the losses summed over the
    data ranks and world 1's parameters gathered from the shards are world
    1's step and the JAX package's FSDP step."""
    world1, ranks, start = runs["SGD", 1], runs["SGD", w], runs["weights"]
    j_m, j_s = jax_fsdp_tp
    m = w // 2
    got = summed(ranks, 0, m)
    moved = param_err(world1["student"], start)
    for label, want_m, want_s in (("world 1", world1["metrics"][0],
                                   world1["student"]),
                                  ("the JAX mesh", j_m, j_s)):
        lerr, perr = loss_err(got, want_m), param_err(
            ranks[0][0]["student"], want_s)
        print(f"FSDP at W={w} against {label}: losses {lerr:.3g} relative "
              f"(tol {LOSS_RTOL}), parameters {perr:.3g} (tol "
              f"{PARAM_ATOL}); the student moved {moved:.3g}")
        assert lerr <= LOSS_RTOL and perr <= PARAM_ATOL
    assert moved >= 100 * PARAM_ATOL
    assert chosen(ranks), "FSDP split no parameter"
    if w == 4:  # the box head's expand layer keeps its model split
        shards = ranks[0][0]["bytes"]["shards"]
        assert shards["roi_heads.box_head.fc1.weight"][0] == "model"
        assert shards["roi_heads.box_head.fc2.weight"][0] == "model"


@pytest.mark.parametrize("opt", ["SGD", "ADAMW"])
def test_each_rank_holds_half_of_every_chosen_leaf(runs, opt):
    """At D = 2 every chosen leaf's parameter, optimizer moments and
    teacher hold half of world 1's elements on each rank; the rank's bytes
    of each drop by that much."""
    world1, ranks = runs[opt, 1], runs[opt, 2]
    full = {n: t.numel() for n, t in world1["student"].items()}
    leaves = chosen(ranks)
    n_moments = {"SGD": 1, "ADAMW": 2}[opt]
    saved = 0
    for r in ranks:
        b = r[0]["bytes"]
        assert chosen([r]).keys() == leaves.keys()
        for name, (_, param, moments, teacher) in b["shards"].items():
            if name not in leaves:
                continue
            assert param * 2 == full[name] and teacher * 2 == full[name]
            assert moments == [param] * n_moments, (name, moments)
        saved = sum(full[n] // 2 * 4 for n in leaves)
        w1 = world1["bytes"]
        for part in ("student", "teacher"):
            assert b[part] == w1[part] - saved
        assert b["moments"] == w1["moments"] - n_moments * saved
    print(f"{opt}: {len(leaves)} leaves split, each rank holds "
          f"{ranks[0][0]['bytes']['student'] / 2**20:.2f} MiB of student "
          f"parameters (world 1: {world1['bytes']['student'] / 2**20:.2f}), "
          f"{ranks[0][0]['bytes']['moments'] / 2**20:.2f} MiB of moments "
          f"({world1['bytes']['moments'] / 2**20:.2f}), "
          f"{ranks[0][0]['bytes']['teacher'] / 2**20:.2f} MiB of teacher "
          f"({world1['bytes']['teacher'] / 2**20:.2f})")


def test_adamw_moments_gather_into_world1s(runs):
    """ADAMW at D = 2: the losses are world 1's and both moments, gathered
    from the halves, are world 1's."""
    world1, ranks = runs["ADAMW", 1], runs["ADAMW", 2]
    lerr = loss_err(summed(ranks, 0, 1), world1["metrics"][0])
    got, want = ranks[0][0]["moments"], world1["moments"]
    assert got.keys() == want.keys()
    worst = {}
    for i, s in want.items():
        for k, v in s.items():
            if v.ndim:
                err = float((got[i][k] - v).abs().max()) / max(
                    float(v.abs().max()), 1e-30)
                worst[k] = max(worst.get(k, 0.0), err)
    print(f"ADAMW at D=2: losses {lerr:.3g} relative, moments {worst} "
          f"relative (tol {MOMENT_RTOL})")
    assert lerr <= LOSS_RTOL
    assert worst.keys() == {"exp_avg", "exp_avg_sq"}
    assert max(worst.values()) <= MOMENT_RTOL


def test_fsdp_averaging_exceeds_the_tolerance(runs):
    """The planted fault: FSDP's reduce-scatter averaged over the data
    ranks instead of summed."""
    world1, ranks = runs["SGD", 1], runs["SGD", 2]
    perr = param_err(ranks[0][1]["student"], world1["student"])
    print(f"fsdp averaged planted at D=2: parameters {perr:.3g}")
    assert perr > PARAM_ATOL
