"""The data x model grid's ranks for the tensor-parallel and FSDP tests of
the port (``aldi_tpu_torch/parallel/``), without JAX: spawned children
import this module, torch and ``aldi_tpu_torch`` only.

``grid_steps(rank, world, model, ...)`` makes the grid of ``model`` model
ranks (``mesh.make_grid``) in a rank of ``tests/torch_port_dist.py``
``run_ranks``, then runs ``steps``: the port's training steps of a config
on the rank's share of each global batch and of its draws, returning the
metrics, world 1's state dicts gathered from the shards, the rank's own
parameters and what its state holds in bytes. ``plant(fault)`` plants one
of ``FAULTS`` in the rank for the duration, to show that the tests'
tolerances catch it.
"""

import contextlib

FAULTS = (
    # the model group's all-reduces over the default group (the W ranks)
    "tp over the default group",
    # a row-parallel layer's bias added on every model rank, then summed
    "bias per model rank",
    # the loss denominators and BatchNorm statistics over the W ranks
    "denominators over W",
    # FSDP's gradients averaged over the data ranks instead of summed
    "fsdp averaged",
)


@contextlib.contextmanager
def plant(fault):
    """``fault`` (one of ``FAULTS``, or None) planted in this process."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from aldi_tpu_torch.engine import distill
    from aldi_tpu_torch.models import detr, rcnn, roi_heads, rpn, yolo
    from aldi_tpu_torch.parallel import mesh, tensor

    def default_group_sum(x):
        y = x.to(torch.float32).contiguous()
        dist.all_reduce(y)
        return y.to(x.dtype)

    def world_count(x):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    def bias_inside(self, x):
        dt = self.compute_dtype
        return tensor.reduce_from_model(F.linear(
            x.to(dt), self.weight.to(dt), self.bias.to(dt)))

    def averaged(x, group=None):
        return saved_rs(x, group) / dist.get_world_size(group)

    saved_rs = mesh.reduce_scatter_flat
    patches = {
        None: [],
        "tp over the default group": [(tensor, "_all_reduce_model",
                                       default_group_sum)],
        "bias per model rank": [(tensor.RowParallelLinear, "forward",
                                 bias_inside)],
        "denominators over W": [
            *[(m, "global_count", world_count)
              for m in (roi_heads, distill, detr, yolo)],
            *[(m, "global_batch", lambda n: n * mesh.world())
              for m in (rpn, rcnn, yolo, detr)],
            *[(m, "batch_mean", lambda x: x.mean() / mesh.world())
              for m in (rcnn, yolo)]],
        "fsdp averaged": [(mesh, "reduce_scatter_flat", averaged)],
    }[fault]
    saved = [(m, k, getattr(m, k)) for m, k, _ in patches]
    for m, k, f in patches:
        setattr(m, k, f)
    try:
        yield
    finally:
        for m, k, f in saved:
            setattr(m, k, f)


def _cfg(cfg_dict):
    from aldi_tpu_torch.config.cfg_node import CfgNode

    return CfgNode(cfg_dict)


def state_bytes(state) -> dict:
    """The bytes of the rank's student parameters, optimizer state tensors
    and teacher parameters, and per split parameter (by name) its axis and
    element counts: (axis, parameter, each optimizer tensor, teacher)."""
    from aldi_tpu_torch.parallel.mesh import shard_of

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    opt = state.optimizer.state
    teacher = (dict(state.teacher.named_parameters())
               if state.teacher is not None else {})
    moments = [t for s in opt.values() for t in s.values()
               if getattr(t, "ndim", 0) > 0]
    shards = {}
    for n, p in state.student.named_parameters():
        s = shard_of(p)
        if s is not None:
            shards[n] = (s.axis, p.numel(),
                         [t.numel() for t in opt.get(p, {}).values()
                          if getattr(t, "ndim", 0) > 0],
                         teacher[n].numel() if n in teacher else None)
    return {"student": nbytes(state.student.parameters()),
            "moments": nbytes(moments),
            "teacher": nbytes(teacher.values()), "shards": shards}


def _vit(vit):
    """The port's ``VIT_CONFIGS["b"]`` set to ``vit`` (a spawned rank
    imports the full ViT-B's)."""
    if vit is not None:
        from aldi_tpu_torch.models import vit as port_vit

        port_vit.VIT_CONFIGS["b"] = dict(vit)


def inference(cfg_dict, weights, images, sizes):
    """``forward_inference`` of the student that ``create_train_state``
    makes from world 1's ``weights`` (split on the grid), on this rank's
    ``images``: (boxes, scores, classes, valid) as numpy arrays."""
    import torch

    from aldi_tpu_torch.engine.train_step import create_train_state
    from aldi_tpu_torch.models import build_detector

    cfg = _cfg(cfg_dict)
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, weights)
    with torch.no_grad():
        out = det.forward_inference(images, sizes, module=state.student)
    return [t.numpy() for t in out]


def grid_inference(rank, world, model, cfg_dict, weights, images, sizes,
                   vit=None):
    """``inference`` on the grid of ``model`` model ranks."""
    from aldi_tpu_torch.parallel import mesh

    _vit(vit)
    mesh.make_grid(model)
    return inference(cfg_dict, weights, images, sizes)


def steps(cfg_dict, weights, batches, draws, accum=1):
    """The port's steps of the config ``cfg_dict`` from world 1's
    ``weights`` on this rank's share of each global batch and its draws
    (``shard_batch``, ``shard_draws``: the data index's). Returns per step
    the rank's metrics, world 1's student and teacher state dicts and
    optimizer state after the last step (``mesh.full_state_dict``,
    ``full_optimizer_state``), the rank's replicated parameters and
    ``state_bytes``."""
    from aldi_tpu_torch.engine.train_step import (create_train_state,
                                                  make_train_step)
    from aldi_tpu_torch.models import build_detector
    from aldi_tpu_torch.parallel import mesh

    cfg = _cfg(cfg_dict)
    det = build_detector(cfg, device="cpu")
    state = create_train_state(cfg, det, weights)
    step = make_train_step(cfg, det)
    metrics = []
    for batch, d in zip(batches, draws):
        state, m = step(state, mesh.shard_batch(batch, accum),
                        mesh.shard_draws(d, accum))
        metrics.append({k: float(v) for k, v in m.items()})
    from aldi_tpu_torch.engine.checkpoint import full_optimizer_state

    out = {"metrics": metrics,
           "student": mesh.full_state_dict(state.student),
           "moments": full_optimizer_state(state.optimizer)["state"],
           "replicated": {n: p.detach().clone() for n, p in
                          state.student.named_parameters()
                          if mesh.shard_of(p) is None},
           "bytes": state_bytes(state)}
    if state.teacher is not None:
        out["teacher"] = mesh.full_state_dict(state.teacher)
    return out


def grid_steps(rank, world, model, cfg_dict, weights, batches, draws,
               faults=(None,), accum=1, vit=None):
    """On the grid of ``model`` model ranks (with the port's ViT-B config
    ``vit``, if given): ``steps`` once per entry of ``faults`` with that
    fault planted (None: none). Returns their results in that order."""
    from aldi_tpu_torch.parallel import mesh

    _vit(vit)
    mesh.make_grid(model)
    out = []
    for fault in faults:
        with plant(fault):
            out.append(steps(cfg_dict, weights, batches, draws, accum))
    return out
