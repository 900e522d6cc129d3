"""Data-parallel training across processes, one per GPU.

Counterpart of ``aldi_tpu/parallel/mesh.py``. The JAX package shards the
global batch on the ``data`` axis of a device mesh and replicates the
state; XLA inserts the gradient all-reduce, so every loss denominator,
every random draw and YOLO's BatchNorm statistics are those of the global
batch. Here each process (a rank of W) holds 1/W of that global batch and
computes its share of the global-batch loss: numerators over its own
images, every denominator global (``global_count``, ``global_batch``,
``batch_mean``). The gradients are summed across the ranks once per step
(``all_reduce_grads``), after the last backward and before clipping and the
optimizer, so the world-W step is the world-1 step on the concatenated
batch up to summation order.

With ``TPU.GRAD_ACCUM = k`` rank r holds, for each chunk c of the global
batch, its contiguous 1/W of that chunk (``shard_positions``): chunk c, with
its chunk-local denominators and BatchNorm statistics, is then the chunk of
the JAX package's ``lax.scan`` over the sharded global batch. Every rank
draws the global batch's draws from the same generator and keeps its own
(``shard_draws``).

Without a process group, or with a group of one, every function returns
its input untouched: the world-1 step is bitwise the step without a group.

The collectives' contract: every rank calls them in the same order, with
tensors of the same shapes. The losses that take a global denominator
(``models/rpn.py``, ``roi_heads.py``, ``rcnn.py``, ``yolo.py``,
``detr.py``, ``engine/distill.py``) and YOLO's sync-BN all-reduce inside
the step, so every rank runs the same streams, chunks and loss terms,
whatever its data: a loss or a BatchNorm that one rank skips (a branch on
its own pseudo-label count, a rank-0-only evaluation) breaks the order.
Such a call does not hang: gloo fails it when the sizes disagree or the
peer leaves, and every group has a ``timeout`` after which a collective
that no peer joins raises.

``spawn`` runs a function in one spawned process per rank, joined in a
group, and returns every rank's result: ``tools/train_net.py``'s
launcher, ``chip_smoke.py`` and the tests use it.

The data x model grid (``make_grid``, the JAX package's 2-D mesh,
``aldi_tpu/parallel/mesh.py:31-50``): W = D x M ranks, the model axis
inner, so rank r has data index r // M and model index r % M and a model
group is M adjacent cards. The M ranks of a model group hold the same
share of the global batch and the same draws (``data_rank``,
``data_world``); the reductions above run over the data group, so model
ranks are never counted as data ranks. ``tp_spec`` and ``fsdp_spec`` choose
the leaves that ``parallel/tensor.py`` (Megatron pairs over the model
group) and ``parallel/fsdp.py`` (ZeRO shards over the data group) split,
with the JAX package's rules on the port's names and PyTorch layouts; a
split parameter carries its ``Shard``, from which ``full_tensor`` and
``local_part`` go between the rank's part and world 1's tensor. Without a
grid, or at M = 1 without FSDP, every function is the data-parallel one
above, bitwise.
"""

import datetime
import io
import os
import queue
import re
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that never completes fails the run after this long
TIMEOUT = datetime.timedelta(minutes=10)
BUCKET_BYTES = 25 << 20  # gradient all-reduce bucket (DDP's default size)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """The rank's card on its machine: ``LOCAL_RANK`` as ``torchrun`` and
    ``tools/train_net.py``'s launcher set it, else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def init_process_group(device_type: str, init_method: str = "env://",
                       world_size=None, rank=None, backend=None,
                       timeout=TIMEOUT) -> None:
    """Join a process group: ``backend`` if given (``chip_smoke.py`` asks
    for gloo on the card, where two ranks share one), else NCCL on ``cuda``
    and gloo on ``cpu``. ``init_method`` ``env://`` reads ``torchrun``'s
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); ``tcp://`` and
    ``file://`` take ``world_size`` and ``rank``. The grid's groups
    (``make_grid``) take the same ``timeout``."""
    dist.init_process_group(
        backend or ("nccl" if device_type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)
    _process["timeout"] = timeout


def init_from_env(device_type: str) -> bool:
    """Join the group that ``torchrun``'s environment describes
    (``WORLD_SIZE`` > 1), unless the caller has made one. Returns whether
    a group exists."""
    if is_initialized():
        return True
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    init_process_group(device_type)
    return True


def comm_device() -> torch.device:
    """Where this rank's host-side collectives (gathers) put their tensors:
    the current card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if world() > 1:
        dist.barrier()


def is_main() -> bool:
    """Rank 0 writes the run's files (metrics, checkpoints, logs)."""
    return rank() == 0


# ------------------------------------------------------------- the grid
# the process's grid (``make_grid``) and its groups' timeout; one process
# is one rank, as ``torch.distributed``'s default group is per process
_process = {"grid": None, "timeout": TIMEOUT}


@dataclass(frozen=True)
class Grid:
    """D data ranks x M model ranks; this rank's indices and its groups
    (None: the default group, or no group to reduce over)."""
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None


def make_grid(model_parallel: int = 1) -> Grid:
    """The grid of the group's W ranks (``make_mesh(W, model_parallel)``):
    D = W // M data ranks of M model ranks each, the model axis inner.
    Every rank makes every group, in the same order (``dist.new_group``
    otherwise waits for the missing ranks until the timeout). At M = 1 no
    group is made: the data group is the default group."""
    m = max(int(model_parallel), 1)
    w, r = world(), rank()
    if w % m:
        raise ValueError(f"{w} devices not divisible by TPU.MESH_MODEL={m}")
    data_group = model_group = None
    if m > 1:
        timeout = _process["timeout"]
        for i in range(w // m):  # model groups: M adjacent ranks
            g = dist.new_group(list(range(i * m, (i + 1) * m)),
                               timeout=timeout)
            if i == r // m:
                model_group = g
        for j in range(m):  # data groups: every M-th rank
            g = dist.new_group(list(range(j, w, m)), timeout=timeout)
            if j == r % m:
                data_group = g
    _process["grid"] = Grid(w // m, m, r // m, r % m, data_group,
                            model_group)
    return _process["grid"]


def drop_grid() -> None:
    """Forget the process's grid (its groups go with the process group)."""
    _process["grid"] = None


def check_grid(cfg) -> None:
    """Raise on mesh settings that the group cannot hold: W not divisible
    by TPU.MESH_MODEL (the JAX package's ``make_mesh`` error), or a
    TPU.MESH_DATA other than W // M (each rank is one card)."""
    t = cfg.TPU
    m = max(int(t.MESH_MODEL), 1)
    if world() % m:
        raise ValueError(
            f"{world()} devices not divisible by TPU.MESH_MODEL={m}")
    if t.MESH_DATA not in (0, world() // m):
        raise ValueError(
            f"TPU.MESH_DATA={t.MESH_DATA} but the process group has "
            f"{world()} ranks and TPU.MESH_MODEL={m}: the data axis is "
            f"{world() // m} ranks of one GPU each")


def data_rank() -> int:
    g = _process["grid"]
    return rank() if g is None else g.data_rank


def data_world() -> int:
    g = _process["grid"]
    return world() if g is None else g.data


def model_rank() -> int:
    g = _process["grid"]
    return 0 if g is None else g.model_rank


def model_world() -> int:
    g = _process["grid"]
    return 1 if g is None else g.model


def data_group():
    g = _process["grid"]
    return None if g is None else g.data_group


def model_group():
    g = _process["grid"]
    return None if g is None else g.model_group


# ------------------------------------------------------------ the specs
# Megatron pairs (``aldi_tpu/parallel/mesh.py:53-98``) on the port's names:
# expand (column-parallel: a Linear's out features, weight [out, in] and
# bias) and contract (row-parallel: its in features; the bias replicated).
# JAX's ``mlp_fc1`` is the port's ``mlp.fc1``; detectron2's qkv [3C, C]
# has rows (3, heads, head_dim) and proj [C, C] columns (heads, head_dim).
_TP_EXPAND = re.compile(r"(^|\.)(fc1|pwconv1|linear1)\.(weight|bias)$")
_TP_CONTRACT = re.compile(r"(^|\.)(fc2|pwconv2|linear2)\.weight$")
_TP_ATTN_QKV = re.compile(r"(^|\.)attn\.qkv\.(weight|bias)$")
_TP_ATTN_PROJ = re.compile(r"(^|\.)attn\.proj\.weight$")
# a leaf below this element count stays replicated under FSDP
FSDP_MIN_ELEMS = 1 << 16


def tp_spec(name: str, shape, m: int, heads: Optional[int] = None):
    """How the model axis splits parameter ``name`` of ``shape``: "column"
    (dim 0 in M contiguous parts), "row" (dim 1), "heads" (qkv's dim 0: q,
    k and v each split by heads), or None (replicated: no rule, or the
    split dim does not divide M, as JAX's ``tp_spec`` returns ``P()``).
    ``heads``: the attention's head count, for qkv and proj."""
    ndim = len(shape)
    if _TP_EXPAND.search(name) and ndim >= 1:
        return "column" if shape[0] % m == 0 else None
    if _TP_CONTRACT.search(name) and ndim == 2:
        return "row" if shape[1] % m == 0 else None
    if _TP_ATTN_QKV.search(name) and heads:
        return "heads" if heads % m == 0 else None
    if _TP_ATTN_PROJ.search(name) and ndim == 2 and heads:
        return "row" if heads % m == 0 else None
    return None


def fsdp_spec(shape, d: int) -> bool:
    """Whether FSDP splits a leaf of ``shape`` over D data ranks: at least
    ``FSDP_MIN_ELEMS`` elements and a dimension divisible by D (JAX's
    ``fsdp_spec``). The port splits a chosen leaf's flattened elements in D
    contiguous parts (D divides their count)."""
    return (int(np.prod(shape)) >= FSDP_MIN_ELEMS
            and any(s % d == 0 for s in shape))


@dataclass(frozen=True)
class Shard:
    """A parameter's part of world 1's tensor of ``shape``: over the
    "model" axis as ``tp_spec``'s kind, or over the "data" axis as a
    "flat" 1/D of its flattened elements."""
    axis: str
    kind: str
    shape: tuple


def shard_of(t) -> Optional[Shard]:
    return getattr(t, "_grid_shard", None)


def set_shard(p: torch.Tensor, shard: Shard) -> torch.Tensor:
    p._grid_shard = shard
    return p


def _axis(shard: Shard):
    """(index, parts, group) of this rank on the shard's axis."""
    if shard.axis == "data":
        return data_rank(), data_world(), data_group()
    return model_rank(), model_world(), model_group()


def local_part(full: torch.Tensor, shard: Shard, index=None,
               parts=None) -> torch.Tensor:
    """Part ``index`` of ``parts`` (this rank's by default) of world 1's
    tensor ``full``: a contiguous copy."""
    if index is None:
        index, parts, _ = _axis(shard)
    if shard.kind == "flat":
        n = full.numel() // parts
        return full.reshape(-1)[index * n:(index + 1) * n].clone()
    if shard.kind == "heads":
        rest = full.shape[1:]
        return full.reshape(3, parts, -1, *rest)[:, index].reshape(
            -1, *rest).clone()
    return full.chunk(parts, 0 if shard.kind == "column" else 1)[
        index].contiguous().clone()


def full_tensor(local: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """World 1's tensor from every rank's part on the shard's axis (a
    collective of the shard's group); ``local`` itself without a shard."""
    if shard is None:
        return local
    _, parts, group = _axis(shard)
    flat = all_gather_flat(local.detach(), group)
    if shard.kind == "flat":
        return flat.view(shard.shape)
    chunks = flat.chunk(parts)
    if shard.kind == "heads":
        rest = shard.shape[1:]
        return torch.stack([c.view(3, -1, *rest) for c in chunks],
                           1).reshape(shard.shape)
    dim = 0 if shard.kind == "column" else 1
    return torch.cat([c.view(local.shape) for c in chunks], dim)


def copy_shards(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Tag ``dst``'s parameters with the shards of ``src``'s of the same
    names (``copy.deepcopy`` of a split module keeps the values, not the
    tags)."""
    tags = {n: shard_of(p) for n, p in src.named_parameters()}
    for n, p in dst.named_parameters():
        if tags.get(n) is not None:
            set_shard(p, tags[n])


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` with each split parameter gathered into
    world 1's tensor (a collective: every rank calls it, in the same
    order)."""
    sd = module.state_dict()
    for name, p in module.named_parameters():
        if shard_of(p) is not None:
            sd[name] = full_tensor(p, shard_of(p))
    return sd


def local_state_dict(module: torch.nn.Module, full: dict) -> dict:
    """World 1's state dict ``full`` cut to this rank's parts of
    ``module``'s split parameters (no collective)."""
    sd = dict(full)
    for name, p in module.named_parameters():
        if shard_of(p) is not None and name in sd:
            sd[name] = local_part(sd[name], shard_of(p))
    return sd


# ------------------------------------------------------ the collectives
def all_gather_flat(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` (same shape on each) flattened and concatenated in
    rank order of ``group``. (Gloo takes CUDA tensors, bfloat16 included,
    in each collective used here, as torch 2.11's build on the card
    showed: nothing is staged through the host.)"""
    src = x.contiguous().reshape(-1)
    out = torch.empty(dist.get_world_size(group) * src.numel(),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


def reduce_scatter_flat(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's 1/n of the n ranks' ``x`` (flat, same size on each)
    summed: ``reduce_scatter_tensor`` with SUM."""
    src = x.contiguous().reshape(-1)
    out = torch.empty(src.numel() // dist.get_world_size(group),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


# ------------------------------------------------------------ the batch
def shard_positions(batch: int, accum: int = 1, rank_=None,
                    world_=None) -> np.ndarray:
    """The positions in a global batch of ``batch`` images that a rank
    holds: for each of the ``accum`` chunks, its contiguous 1/D. By
    default this rank's data index of D: the M ranks of a model group hold
    the same images."""
    r = data_rank() if rank_ is None else rank_
    w = data_world() if world_ is None else world_
    if batch % (accum * w):
        raise ValueError(f"a global batch of {batch} images does not split "
                         f"into TPU.GRAD_ACCUM={accum} chunks over {w} ranks")
    chunk = batch // accum
    per = chunk // w
    return np.asarray([c * chunk + r * per + i for c in range(accum)
                       for i in range(per)], np.int64)


def shard_batch(batch, accum: int = 1, rank_=None, world_=None):
    """A rank's share (``shard_positions``) of a nested dict of global
    batch tensors, on axis 0: what its loader delivers."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, accum, rank_, world_)
                for k, v in batch.items()}
    pos = shard_positions(batch.shape[0], accum, rank_, world_)
    return batch[torch.from_numpy(pos).to(batch.device)]


def shard_draws(draws: dict, accum: int = 1, rank_=None,
                world_=None) -> dict:
    """A rank's share of the global batch's draws (``draw_step`` on the
    global batch sizes), along each draw's batch axis: the last for the
    drop-path keep masks (``"drop"``, [..., B]), else the first. A student
    stream's per-chunk list: each chunk's contiguous 1/D; every other
    entry (a stream without chunks, the teacher's, the strong views'):
    ``shard_positions``. DETR's dropout seed draws the masks of the whole
    chunk: the rank's rows (data index, D) go beside it as
    ``"dropout_rows"``. With one data rank the draws as they are."""
    r = data_rank() if rank_ is None else rank_
    w = data_world() if world_ is None else world_
    if w == 1:
        return draws

    def take(tree, chunks, key=None):
        if isinstance(tree, list):
            return [take(c, 1) for c in tree]
        if isinstance(tree, dict):
            out = {k: take(v, chunks, k) for k, v in tree.items()}
            if "dropout" in tree:
                out["dropout_rows"] = (r, w)
            return out
        if not isinstance(tree, torch.Tensor):
            return tree
        axis = tree.ndim - 1 if key == "drop" else 0
        pos = shard_positions(tree.shape[axis], chunks, r, w)
        return tree.index_select(axis, torch.from_numpy(pos).to(tree.device))

    return {name: take(v, accum) for name, v in draws.items()}


# ------------------------------------------------------- the reductions
def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count (or any additive statistic) summed over the data ranks: an
    all-reduce SUM of a detached copy over the data group. With one data
    rank, ``x`` itself."""
    if data_world() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=data_group())
    return y


def global_batch(n: int) -> int:
    """The global batch's image count for a rank holding ``n`` images:
    every data rank holds as many (``shard_positions``)."""
    return n * data_world()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """A rank's share of the global batch's mean of a tensor that has the
    same shape on every rank (its batch axis the rank's images): its own
    mean over D. With one data rank, ``x.mean()``."""
    m = x.mean()
    return m if data_world() == 1 else m / data_world()


def grad_buckets(params, bucket_bytes: int = BUCKET_BYTES, skip="data"):
    """The gradients of ``params`` that exist (a frozen parameter has
    none, and every rank runs the same graph, so the set is the same on
    every rank) and are not split on the axis ``skip`` (by default FSDP's
    shards, which ``parallel/fsdp.py`` sums as it makes them), in buckets
    of one dtype and device up to ``bucket_bytes``."""
    buckets, current, size = [], [], 0
    for g in (p.grad for p in params if p.grad is not None
              and getattr(shard_of(p), "axis", None) != skip):
        if current and (size + g.numel() * g.element_size() > bucket_bytes
                        or g.dtype != current[0].dtype
                        or g.device != current[0].device):
            buckets.append(current)
            current, size = [], 0
        current.append(g)
        size += g.numel() * g.element_size()
    if current:
        buckets.append(current)
    return buckets


def reduce_buckets(buckets, group=None, mean=False) -> int:
    """All-reduce SUM (``mean``: divided by the group's size) of each
    bucket over ``group`` through one flat buffer, written back into the
    gradients. Returns the bytes reduced."""
    total = 0
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        if mean:
            flat /= dist.get_world_size(group)
        offset = 0
        for g in bucket:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
        total += flat.numel() * flat.element_size()
    return total


def all_reduce_grads(params) -> int:
    """Sum the trainable gradients across the data ranks (once per step,
    after the last backward): the replicated and the tensor-parallel
    parameters' (a model rank's TP shard is its own). Under a model axis
    the model peers' gradients of every parameter the axis does not split
    are first averaged over the model group: the peers compute the same
    values, but on the card not always to the last bit (cuDNN's and the
    atomics' orders), and their copies must stay one. Returns the bytes
    reduced: 0 with one rank of each, where nothing is touched."""
    total = 0
    if model_world() > 1:
        total += reduce_buckets(grad_buckets(params, skip="model"),
                                model_group(), mean=True)
    if data_world() > 1:
        total += reduce_buckets(grad_buckets(params), data_group())
    return total


def sum_of_squares(params) -> torch.Tensor:
    """The squared global norm of the gradients of ``params`` as world 1
    would sum it: a replicated gradient once, a sharded one's squares
    summed over the group that shards it (one all-reduce per axis)."""
    split = {None: [], "model": [], "data": []}
    for p in params:
        if p.grad is not None:
            split[getattr(shard_of(p), "axis", None)].append(p.grad)
    total = sum((g.to(torch.float32) ** 2).sum() for g in split[None])
    for axis, group in (("model", model_group()), ("data", data_group())):
        if split[axis]:
            part = sum((g.to(torch.float32) ** 2).sum() for g in split[axis])
            dist.all_reduce(part, group=group)
            total = total + part
    return total


def reduce_metrics(metrics: dict) -> dict:
    """The data ranks' shares of each scalar metric summed (one all-reduce
    of the stacked values over the data group: a model group's ranks hold
    the same shares); with one data rank the metrics as they are."""
    if data_world() == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    dev = next((v.device for v in metrics.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=dev).reshape(())
                        for k in keys])
    dist.all_reduce(vals, group=data_group())
    return dict(zip(keys, vals.unbind()))


def broadcast_state(*modules) -> None:
    """Every parameter and buffer of ``modules`` made rank 0's: a
    replicated one from rank 0, a tensor-parallel shard from its model
    column's first data rank (its peers hold other shards of the same
    shape), an FSDP shard not at all (every rank kept its part of the same
    full state)."""
    if world() == 1:
        return
    for m in modules:
        if m is None:
            continue
        for t in m.state_dict(keep_vars=True).values():
            axis = getattr(shard_of(t), "axis", None)
            if axis is None:
                dist.broadcast(t.detach(), 0)
            elif axis == "model" and data_world() > 1:
                dist.broadcast(t.detach(), model_rank(), group=data_group())


# ------------------------------------------------------------ processes
def send(out_q, index, fn, *args) -> None:
    """``fn(*args)`` in a spawned process: puts (``index``, True, its
    result as ``torch.save`` bytes) on ``out_q``, or (``index``, False,
    the traceback). Bytes, because torch's queue pickling would share
    tensors through file descriptors that die with the process."""
    try:
        buf = io.BytesIO()
        torch.save(fn(*args), buf)
        out_q.put((index, True, buf.getvalue()))
    except BaseException:
        out_q.put((index, False, traceback.format_exc()))


def collect(procs, out_q, timeout=None) -> list:
    """The results that ``procs`` ``send`` to ``out_q``, in index order.
    Raises on a process's error, on a process that died without a result,
    and after ``timeout`` seconds (None: no limit)."""
    results = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    while len(results) < len(procs):
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise TimeoutError(f"{len(procs) - len(results)} of "
                               f"{len(procs)} processes did not finish "
                               f"within {timeout:.0f} s")
        try:
            index, ok, out = out_q.get(timeout=min(left or 1.0, 1.0))
        except queue.Empty:
            dead = [i for i, p in enumerate(procs)
                    if p.exitcode not in (None, 0) and i not in results]
            if dead:
                raise RuntimeError(f"process {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}") from None
            continue
        if not ok:
            raise RuntimeError(f"process {index} raised:\n{out}")
        results[index] = torch.load(io.BytesIO(out), weights_only=False)
    return [results[i] for i in range(len(procs))]


def _in_group(fn, local, rank_, world_, init_method, device_type, backend,
              group_timeout, args):
    os.environ.update(LOCAL_RANK=str(local), RANK=str(rank_),
                      WORLD_SIZE=str(world_))
    if device_type == "cuda" and (backend or "nccl") == "nccl":
        torch.cuda.set_device(local)  # NCCL: one card per rank
    init_process_group(device_type, init_method, world_, rank_, backend,
                       group_timeout)
    try:
        return fn(rank_, world_, *args)
    finally:
        drop_grid()
        dist.destroy_process_group()


def _rank_process(out_q, local, fn, *group):
    send(out_q, local, _in_group, fn, local, *group)


def spawn(fn, world_, init_method, *args, device_type="cpu", backend=None,
          nprocs=None, first_rank=0, timeout=None, group_timeout=TIMEOUT):
    """``fn(rank, world, *args)`` in ``nprocs`` (by default ``world_``)
    spawned processes, ranks ``first_rank`` on, each joined in the group
    of ``world_`` ranks at ``init_method`` (``init_process_group``; under
    NCCL each on its card ``cuda:LOCAL_RANK``) with ``LOCAL_RANK``,
    ``RANK`` and ``WORLD_SIZE`` set. ``fn`` is a module-level function.
    Returns the processes' results in rank order. A rank that raises or
    dies, or ranks not done within ``timeout`` seconds (None: no limit),
    stop every process and raise here."""
    import multiprocessing

    nprocs = world_ if nprocs is None else nprocs
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_process, args=(
        out_q, local, fn, first_rank + local, world_, init_method,
        device_type, backend, group_timeout, args))
        for local in range(nprocs)]
    for p in procs:
        p.start()
    done = False
    try:
        out = collect(procs, out_q, timeout)
        done = True
        return out
    finally:
        for p in procs:
            if done:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join()
