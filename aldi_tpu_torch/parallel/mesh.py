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

Tensor parallelism (``TPU.MESH_MODEL`` > 1) and FSDP (``TPU.FSDP``) are not
ported: ROADMAP.md queues them.
"""

import datetime
import io
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# a collective that never completes fails the run after this long
TIMEOUT = datetime.timedelta(minutes=10)
BUCKET_BYTES = 25 << 20  # gradient all-reduce bucket (DDP's default size)
NOT_PORTED = ("is not ported yet: ROADMAP.md lists FSDP and tensor "
              "parallelism under 'Modules still to port'")


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
    ``file://`` take ``world_size`` and ``rank``."""
    dist.init_process_group(
        backend or ("nccl" if device_type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)


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


def check_data_parallel(cfg) -> None:
    """Raise on the JAX package's mesh settings that the port does not
    have: a model axis, FSDP, or a data axis other than the group's size."""
    t = cfg.TPU
    if t.MESH_MODEL != 1 or t.FSDP:
        raise NotImplementedError(
            f"TPU.MESH_MODEL={t.MESH_MODEL}, TPU.FSDP={t.FSDP}: model "
            f"sharding {NOT_PORTED}")
    if t.MESH_DATA not in (0, world()):
        raise ValueError(
            f"TPU.MESH_DATA={t.MESH_DATA} but the process group has "
            f"{world()} ranks: the data axis is one rank per GPU")


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


# ------------------------------------------------------------ the batch
def shard_positions(batch: int, accum: int = 1, rank_=None,
                    world_=None) -> np.ndarray:
    """The positions in a global batch of ``batch`` images that a rank
    holds: for each of the ``accum`` chunks, its contiguous 1/W."""
    r = rank() if rank_ is None else rank_
    w = world() if world_ is None else world_
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
    stream's per-chunk list: each chunk's contiguous 1/W; every other
    entry (a stream without chunks, the teacher's, the strong views'):
    ``shard_positions``. DETR's dropout seed draws the masks of the whole
    chunk: the rank's rows (rank, W) go beside it as ``"dropout_rows"``.
    At world 1 the draws as they are."""
    r = rank() if rank_ is None else rank_
    w = world() if world_ is None else world_
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
    """A count (or any additive statistic) summed over the ranks: an
    all-reduce SUM of a detached copy. At world 1, ``x`` itself."""
    if world() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_batch(n: int) -> int:
    """The global batch's image count for a rank holding ``n`` images:
    every rank holds as many (``shard_positions``)."""
    return n * world()


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """A rank's share of the global batch's mean of a tensor that has the
    same shape on every rank (its batch axis the rank's images): its own
    mean over W. At world 1, ``x.mean()``."""
    m = x.mean()
    return m if world() == 1 else m / world()


def grad_buckets(params, bucket_bytes: int = BUCKET_BYTES):
    """The gradients of ``params`` that exist (a frozen parameter has
    none, and every rank runs the same graph, so the set is the same on
    every rank), in buckets of one dtype and device up to
    ``bucket_bytes``."""
    buckets, current, size = [], [], 0
    for g in (p.grad for p in params if p.grad is not None):
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


def reduce_buckets(buckets) -> int:
    """All-reduce SUM of each bucket through one flat buffer, written back
    into the gradients. Returns the bytes reduced."""
    total = 0
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        offset = 0
        for g in bucket:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
        total += flat.numel() * flat.element_size()
    return total


def all_reduce_grads(params) -> int:
    """Sum the trainable gradients across the ranks (once per step, after
    the last backward). Returns the bytes reduced: 0 at world 1, where
    nothing is touched."""
    if world() == 1:
        return 0
    return reduce_buckets(grad_buckets(params))


def reduce_metrics(metrics: dict) -> dict:
    """The ranks' shares of each scalar metric summed (one all-reduce of
    the stacked values); at world 1 the metrics as they are."""
    if world() == 1 or not metrics:
        return metrics
    keys = sorted(metrics)
    dev = next((v.device for v in metrics.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=dev).reshape(())
                        for k in keys])
    dist.all_reduce(vals)
    return dict(zip(keys, vals.unbind()))


def broadcast_state(*modules) -> None:
    """Every parameter and buffer of ``modules`` made rank 0's."""
    if world() == 1:
        return
    for m in modules:
        if m is None:
            continue
        for t in m.state_dict().values():
            dist.broadcast(t, 0)


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
