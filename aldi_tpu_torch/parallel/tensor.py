"""Tensor parallelism over the grid's model group (``TPU.MESH_MODEL``).

Counterpart of the JAX package's ``model`` mesh axis
(``aldi_tpu/parallel/mesh.py:53-98``), where GSPMD inserts the collectives:
here they are written out, as Megatron-LM writes them. ``shard_module``
replaces each Linear that ``mesh.tp_spec`` matches with its parallel form,
holding this model rank's slice of world 1's weight and bias under the
same names, so state dicts keep their keys:

- column-parallel (an expand layer: ViT ``mlp.fc1``, ConvNeXt
  ``pwconv1``, DETR's FFN ``linear1``, the box head's ``fc1``, the
  instance discriminator's ``linear1``; ViT ``attn.qkv`` by heads): the
  input is replicated, the output is the rank's features. The input's
  gradient is all-reduced over the model group (``copy_to_model``).
- row-parallel (its contract partner: ``mlp.fc2``, ``pwconv2``,
  ``linear2``, ``fc2``, ``attn.proj``): the rank's features in, the
  partial products all-reduced over the model group
  (``reduce_from_model``), then the bias, added once.
- a column-parallel layer with no row-parallel partner (the LN conv box
  head's single ``fc1``, ``INS_DA_HIDDEN_DIMS`` of two widths) all-gathers
  its output over the model group (``gather_from_model``).

Between an expand and its contract only elementwise functions run (GELU,
ReLU, DETR's dropout on the rank's columns of world 1's mask), so the
step is world 1's up to the order of the sums. A ViT attention whose qkv
is split runs its ``num_heads / M`` heads (K3a/K3b at G = B x nh / M); its
rel-pos tables, used by every head, take ``copy_to_model`` so their
gradient sums the heads of the whole group. Every model rank then computes
the same replicated outputs, losses and gradients of replicated
parameters (to the last bit on the CPU; on the card cuDNN's and the
atomics' orders may differ between the peers, so ``mesh.all_reduce_grads``
averages those gradients over the model group once a step). The
reductions run in float32 whatever the compute dtype (a bf16 partial
product is widened first), the gathers move the bytes.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import mesh


def _all_reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the model group, in float32, cast back."""
    y = x.to(torch.float32).contiguous()
    dist.all_reduce(y, group=mesh.model_group())
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_model(grad)


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_model(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' last dims concatenated forward; the rank's columns
    of the gradient backward."""

    @staticmethod
    def forward(ctx, x):
        parts = mesh.all_gather_flat(x, mesh.model_group()).view(
            mesh.model_world(), *x.shape)
        return torch.cat(parts.unbind(0), -1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(mesh.model_world(), -1)[mesh.model_rank()] \
            .contiguous()


def copy_to_model(x):
    return _CopyToModel.apply(x)


def reduce_from_model(x):
    return _ReduceFromModel.apply(x)


def gather_from_model(x):
    return _GatherFromModel.apply(x)


def _part(full: torch.Tensor, axis_kind: str) -> nn.Parameter:
    """This model rank's slice of ``full`` as a parameter tagged with its
    ``mesh.Shard``."""
    shard = mesh.Shard("model", axis_kind, tuple(full.shape))
    p = nn.Parameter(mesh.local_part(full.detach(), shard),
                     requires_grad=full.requires_grad)
    return mesh.set_shard(p, shard)


class ColumnParallelLinear(nn.Module):
    """This rank's output features of a Linear (``kind`` "column", or
    "heads" for qkv) in ``compute_dtype``; ``gather``: all-gather the
    output over the model group (no row-parallel partner)."""

    def __init__(self, linear: nn.Linear, kind: str, gather: bool):
        super().__init__()
        self.compute_dtype = linear.compute_dtype
        self.gather = gather
        self.weight = _part(linear.weight, kind)
        self.bias = _part(linear.bias, kind)
        # the rank's columns of a mask over world 1's features (DETR)
        self.split = (mesh.model_rank(), mesh.model_world())

    def forward(self, x):
        dt = self.compute_dtype
        y = F.linear(copy_to_model(x).to(dt), self.weight.to(dt),
                     self.bias.to(dt))
        return gather_from_model(y) if self.gather else y


class RowParallelLinear(nn.Module):
    """This rank's input features of a Linear; the partial products summed
    over the model group, then the (replicated) bias."""

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.compute_dtype = linear.compute_dtype
        self.weight = _part(linear.weight, "row")
        self.bias = linear.bias

    def forward(self, x):
        dt = self.compute_dtype
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)))
        return y + self.bias.to(dt)


def _partner(name: str) -> str:
    """The contract layer's name of an expand layer's (``fc1`` -> ``fc2``,
    ``pwconv1`` -> ``pwconv2``, ``linear1`` -> ``linear2``, ``qkv`` ->
    ``proj``)."""
    return "proj" if name == "qkv" else name[:-1] + "2"


def shard_module(module: nn.Module, m: int) -> list:
    """Replace, in place, every Linear of ``module`` that ``mesh.tp_spec``
    splits over ``m`` model ranks with its parallel form holding this
    rank's slice (of the module's current weights), and split the heads of
    each attention whose qkv is split. Returns the replaced names."""
    replaced = []
    for parent_name, parent in list(module.named_modules()):
        heads = getattr(parent, "num_heads", None) if parent_name.endswith(
            "attn") else None
        for name, child in list(parent.named_children()):
            if not isinstance(child, nn.Linear):
                continue
            full = f"{parent_name}.{name}" if parent_name else name
            kind = mesh.tp_spec(f"{full}.weight", child.weight.shape, m,
                                heads)
            if kind in ("column", "heads"):
                partner = getattr(parent, _partner(name), None)
                paired = isinstance(partner, RowParallelLinear) or (
                    isinstance(partner, nn.Linear) and mesh.tp_spec(
                        f"{full[:-len(name)]}{_partner(name)}.weight",
                        partner.weight.shape, m, heads) == "row")
                setattr(parent, name,
                        ColumnParallelLinear(child, kind, not paired))
            elif kind == "row":
                setattr(parent, name, RowParallelLinear(child))
            else:
                continue
            replaced.append(full)
            if kind == "heads":
                parent.num_heads //= m
                parent.model_parallel = m
    return replaced
