"""FSDP over the grid's data group (``TPU.FSDP``).

Counterpart of the JAX package's ZeRO sharding
(``aldi_tpu/parallel/mesh.py:101-142``): every parameter that
``mesh.fsdp_spec`` chooses (at least 2^16 elements, a dimension divisible
by D) and that the model axis does not split is held as this data rank's
contiguous 1/D of its flattened elements, a parameter tagged with its
``mesh.Shard``. So are, since the optimizer steps on the shards, both
AdamW moments (or SGD's momentum), and, sharded the same way, the EMA
teacher. The FrozenBN buffers that student and teacher share stay
replicated, as every buffer does.

The shards are gathered where they are read: ``shard_module`` gives the
module that owns a chosen parameter a property of the same name that
all-gathers the data group's shards into world 1's tensor at each access
(inside the module's own forward, or a parent's that reads
``child.weight``: a ResNet block's folded FrozenBN convolutions, DETR's
query embedding). Nothing keeps the gathered tensor but the autograd graph,
which frees it after its backward; a block under activation checkpointing
(ViTDet) keeps nothing and gathers again when its forward is recomputed.
The gather's backward reduce-scatters world 1's gradient with SUM over the
data group into the shard's ``.grad`` (the losses carry global
denominators, as ``mesh.all_reduce_grads`` sums), so the step's math is
world 1's; ``all_reduce_grads`` skips the shards.

Every rank reads the same parameters in the same order, so the gathers
pair up; a read on one rank alone (say, code run by rank 0 only) would
wait for peers that never come, until the group's timeout.
"""

import torch
from torch import nn

from . import mesh


class _GatherParam(torch.autograd.Function):
    """World 1's tensor from the data group's shards; backward, this
    rank's shard of the gradients summed over the group."""

    @staticmethod
    def forward(ctx, shard, shape):
        return mesh.all_gather_flat(shard, mesh.data_group()).view(shape)

    @staticmethod
    def backward(ctx, grad):
        return mesh.reduce_scatter_flat(grad, mesh.data_group()), None


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """World 1's tensor of an FSDP shard: differentiable while autograd
    records and ``p`` takes gradients, a plain gather otherwise."""
    shape = mesh.shard_of(p).shape
    if torch.is_grad_enabled() and p.requires_grad:
        return _GatherParam.apply(p, shape)
    with torch.no_grad():
        return _GatherParam.forward(None, p.detach(), shape)


def _gathered(name: str) -> property:
    return property(lambda module: gather_param(module._parameters[name]))


_CLASSES = {}  # (class, sharded names) -> its subclass with the properties


def _gathering_class(cls, names: tuple):
    if (cls, names) not in _CLASSES:
        _CLASSES[cls, names] = type(cls.__name__, (cls,), {
            n: _gathered(n) for n in names})
    return _CLASSES[cls, names]


def shard_module(module: nn.Module, d: int) -> list:
    """Hold, in place, every parameter of ``module`` that ``mesh.fsdp_spec``
    chooses over ``d`` data ranks and no model split holds as this data
    rank's shard of its current value, read through a gathering property.
    Returns the sharded names."""
    sharded, shards = [], {}  # a parameter held twice keeps one shard
    for owner_name, owner in list(module.named_modules()):
        names = []
        for name, p in list(owner._parameters.items()):
            if id(p) not in shards and (
                    p is None or mesh.shard_of(p) is not None
                    or not mesh.fsdp_spec(p.shape, d)):
                continue
            if id(p) not in shards:
                shard = mesh.Shard("data", "flat", tuple(p.shape))
                shards[id(p)] = mesh.set_shard(nn.Parameter(
                    mesh.local_part(p.detach(), shard),
                    requires_grad=p.requires_grad), shard)
            owner._parameters[name] = shards[id(p)]
            names.append(name)
            sharded.append(f"{owner_name}.{name}" if owner_name else name)
        if names:
            owner.__class__ = _gathering_class(type(owner), tuple(names))
    return sharded
