"""Spawned process groups for the data-parallel tests of the port, without
JAX: the children import this module, torch and ``aldi_tpu_torch`` only.

``run_ranks(fn, world, tmp_path, *args)`` runs ``fn(rank, world, *args)``
in ``world`` processes of ``aldi_tpu_torch.parallel.mesh.spawn``, joined in
a gloo group at ``file://<tmp_path>/...`` (no TCP port, so test workers
cannot collide), each with PyTorch's threads capped and the group's
collectives bounded by ``TIMEOUT``; it returns their results in rank
order. A rank that raises, dies or does not finish within the timeout
fails the call. ``run_main(argv, env, timeout)`` runs
``aldi_tpu_torch.tools.train_net`` ``main`` in a spawned process of its own
session (its ranks included), killed whole if it does not finish in time.
"""

import datetime
import functools
import multiprocessing
import os
import signal
import uuid

TIMEOUT = datetime.timedelta(seconds=240)


def _capped(fn, threads, rank, world, *args):
    from tests.torch_port_threads import torch_threads

    with torch_threads(threads):
        return fn(rank, world, *args)


def run_ranks(fn, world, tmp_path, *args, threads=1,
              timeout=TIMEOUT.total_seconds(), group_timeout=TIMEOUT):
    """``fn(rank, world, *args)`` on ``world`` gloo ranks (see the module
    docstring); ``fn`` is a module-level function of a JAX-free module."""
    from aldi_tpu_torch.parallel import mesh

    store = os.path.join(str(tmp_path), f"store-{uuid.uuid4().hex}")
    return mesh.spawn(functools.partial(_capped, fn, threads), world,
                      f"file://{store}", *args, timeout=timeout,
                      group_timeout=group_timeout)


def _main(argv, env):
    os.setsid()  # one session: a timeout kills the launcher and its ranks
    os.environ.update(env)
    from aldi_tpu_torch.tools import train_net

    return train_net.main(train_net.default_argument_parser().parse_args(
        argv))


def _main_process(out_q, argv, env):
    from aldi_tpu_torch.parallel import mesh

    mesh.send(out_q, 0, _main, argv, env)


def run_main(argv, env, timeout=TIMEOUT.total_seconds()):
    """``train_net.main`` on ``argv`` in a spawned process with ``env``
    added to its environment (its ranks inherit it). Returns main's
    result."""
    from aldi_tpu_torch.parallel import mesh

    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    proc = ctx.Process(target=_main_process, args=(out_q, argv, env))
    proc.start()
    try:
        return mesh.collect([proc], out_q, timeout)[0]
    finally:
        if proc.is_alive():
            proc.join(timeout=10)
        if proc.is_alive():
            os.killpg(proc.pid, signal.SIGKILL)
            proc.join(timeout=10)
        assert not proc.is_alive()


# ------------------------------------------------------------- the ranks
def portable(cfg) -> dict:
    """A port config as the plain dict a child rebuilds (``CfgNode`` itself
    does not pickle)."""
    return cfg.to_dict()


def _cfg(cfg_dict):
    from aldi_tpu_torch.config.cfg_node import CfgNode

    return CfgNode(cfg_dict)


def state_of(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def daod_steps(rank, world, cfg_dict, weights, batches, draws, accum=1,
               every_step=False):
    """The port's DAOD steps of the config ``cfg_dict`` (``portable``) on
    a rank's share of each global batch and of its draws
    (``shard_batch``, ``shard_draws``). Returns (per step the rank's
    metrics, the student's and the teacher's state dicts after the last
    step, or with ``every_step`` lists of them after each step)."""
    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  make_train_step)
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.parallel.mesh import shard_batch, shard_draws

    cfg = _cfg(cfg_dict)
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, weights)
    step = make_train_step(cfg, det)
    metrics, students, teachers = [], [], []
    for batch, d in zip(batches, draws):
        state, m = step(state, shard_batch(batch, accum, rank, world),
                        shard_draws(d, accum, rank, world))
        metrics.append({k: float(v) for k, v in m.items()})
        if every_step or len(metrics) == len(batches):
            students.append(state_of(state.student))
            teachers.append(state_of(state.teacher))
    if every_step:
        return metrics, students, teachers
    return metrics, students[-1], teachers[-1]


def collectives(rank, world):
    """``parallel/mesh.py``'s reductions on rank-dependent inputs: their
    results, rank 1's module after ``broadcast_state``, and the gradients
    after ``all_reduce_grads`` through buckets of 64 bytes."""
    import torch

    from aldi_tpu_torch.parallel import mesh

    x = torch.arange(4.0) * (rank + 1)
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in module.parameters():
            p.fill_(rank + 1.0)
    module.weight.grad = torch.full((2, 3), rank + 1.0)
    module.bias.grad = torch.full((2,), 10.0 * (rank + 1))
    params = list(module.parameters())
    buckets = mesh.grad_buckets(params, bucket_bytes=16)
    nbytes = mesh.reduce_buckets(buckets)
    out = {"count": mesh.global_count(x), "mean": mesh.batch_mean(x),
           "metrics": mesh.reduce_metrics({"a": x.sum(), "b": x[0]}),
           "buckets": len(buckets), "bytes": nbytes,
           "grads": [p.grad.clone() for p in params],
           "global_batch": mesh.global_batch(3)}
    mesh.broadcast_state(module)
    out["state"] = state_of(module)
    out["all_reduce_grads"] = mesh.all_reduce_grads(params)
    return out


def rank_conditional_loss(rank, world, peer):
    """Rank 0 alone computes a loss with a global denominator (the ROI
    distillation's, ``global_count``); rank 1 ``peer``: "leaves" (returns,
    as rank-0-only code would let it) or "waits" (at a barrier, a later
    collective of the step)."""
    import torch
    import torch.distributed as dist

    from aldi_tpu_torch.engine.distill import roih_distill_losses

    if rank == 0:
        logits, deltas = torch.zeros(1, 4, 3), torch.zeros(1, 4, 8)
        roih_distill_losses(logits, deltas, logits, deltas,
                            torch.ones(1, 4, dtype=torch.bool), 2)
    elif peer == "waits":
        dist.barrier()
    return rank
