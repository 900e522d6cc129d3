"""Host data pipeline: threaded, deterministic, fixed-shape batch producers,
and the copy of their batches to the card.

Port of ``aldi_tpu/data/loader.py`` (``get_dataset_records``,
``StreamLoader``, ``WeakStrongLoader``, ``TestLoader`` and
``DevicePrefetcher``):

- one canvas-shaped uint8 image per record crosses host -> device; the
  strong views are derived on the device (``data/strong_aug.py``);
- batches are deterministic functions of (seed, batch index): batch k is
  assembled by whichever thread, from records chosen by a counter-based
  RNG with the JAX package's numpy seeds, so a run (and a resumed run,
  through ``seek``) sees the same batches as the JAX package's loader;
- everything is already padded and stacked, so the training loop does no
  per-record Python work.

``DevicePrefetcher`` copies batches to the card from pinned host memory on
a side CUDA stream, ahead of the step that consumes them.
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .catalog import DatasetCatalog
from .coco import filter_empty
from .transforms import transform_record


def get_dataset_records(names, filter_empty_annotations=True) -> List[dict]:
    records = []
    for name in names:
        records.extend(DatasetCatalog.get(name))
    if filter_empty_annotations:
        records = filter_empty(records)
    if not records:
        raise ValueError(f"no records for datasets {names}")
    return records


class StreamLoader:
    """Infinite loader over one record list. next() -> stacked batch dict."""

    def __init__(
        self,
        records: List[dict],
        batch_size: int,
        cfg,
        canvas,
        is_train: bool = True,
        seed: int = 0,
        num_threads: int = 4,
        prefetch: int = 4,
    ):
        self.records = records
        self.batch_size = batch_size
        self.canvas = tuple(canvas)
        self.seed = seed
        self.is_train = is_train
        self.tf_params = dict(
            min_sizes=[int(s) for s in (
                cfg.INPUT.MIN_SIZE_TRAIN if is_train
                else (cfg.INPUT.MIN_SIZE_TEST,)
            )],
            max_size=int(
                cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST
            ),
            canvas=self.canvas,
            flip=cfg.INPUT.RANDOM_FLIP != "none",
            sampling=cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING,
            max_gt=cfg.TPU.MAX_GT,
            bgr=cfg.INPUT.FORMAT.upper() == "BGR",
            crop={
                "enabled": cfg.INPUT.CROP.ENABLED,
                "type": cfg.INPUT.CROP.TYPE,
                "size": list(cfg.INPUT.CROP.SIZE),
            },
            is_train=is_train,
        )
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._next_submit = 0
        self._futures = {}
        self._prefetch = prefetch
        self._next_read = 0
        self._lock = threading.Lock()

    def _indices_for_batch(self, batch_idx: int) -> np.ndarray:
        """Deterministic infinite shuffled sampler: epoch e is a permutation
        seeded by (seed, e)."""
        n = len(self.records)
        start = batch_idx * self.batch_size
        out = []
        while len(out) < self.batch_size:
            epoch, offset = divmod(start + len(out), n)
            perm = np.random.default_rng(
                (self.seed * 1_000_003 + epoch) & 0x7FFFFFFF
            ).permutation(n)
            take = min(self.batch_size - len(out), n - offset)
            out.extend(perm[offset : offset + take])
        return np.asarray(out[: self.batch_size])

    def _make_batch(self, batch_idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 7_368_787 + batch_idx) & 0x7FFFFFFF
        )
        idxs = self._indices_for_batch(batch_idx)
        recs = [
            transform_record(self.records[i], rng, **self.tf_params)
            for i in idxs
        ]
        keys = ["image", "sizes", "boxes", "classes", "valid"]
        return {k: np.stack([r[k] for r in recs]) for k in keys}

    def __iter__(self):
        return self

    def seek(self, batch_idx: int):
        """Fast-forward the sampler to ``batch_idx``. Batch k is a pure
        function of (seed, k), so exact resume needs no replay: the next
        ``next()`` returns exactly the batch a fresh run would have seen at
        iteration k."""
        with self._lock:
            for f in self._futures.values():
                f.cancel()
            self._futures = {}
            self._next_read = batch_idx
            self._next_submit = batch_idx

    def __next__(self) -> Dict[str, np.ndarray]:
        with self._lock:
            while self._next_submit < self._next_read + self._prefetch + 1:
                self._futures[self._next_submit] = self._pool.submit(
                    self._make_batch, self._next_submit
                )
                self._next_submit += 1
            fut = self._futures.pop(self._next_read)
            self._next_read += 1
        return fut.result()


class WeakStrongLoader:
    """Zip of labeled + unlabeled streams -> the train step's batch dict.

    Mirrors the reference loader contract (``aldi/trainer.py:210-240``):
    batch sizes derive from SOLVER.IMS_PER_BATCH split by
    DATASETS.BATCH_CONTENTS / BATCH_RATIOS; either stream may be absent.
    """

    def __init__(self, cfg, canvas, seed: int = 0,
                 num_threads: Optional[int] = None):
        contents = cfg.DATASETS.BATCH_CONTENTS
        ratios = cfg.DATASETS.BATCH_RATIOS
        if len(contents) != len(ratios):
            raise ValueError(
                "BATCH_CONTENTS and BATCH_RATIOS must have equal length")
        total = cfg.SOLVER.IMS_PER_BATCH
        sizes = [int(total * r / sum(ratios)) for r in ratios]
        if sum(sizes) != total:
            raise ValueError(f"SOLVER.IMS_PER_BATCH {total} does not split "
                             f"by BATCH_RATIOS {ratios}: {sizes}")

        labeled_sizes = [
            s for c, s in zip(contents, sizes) if c.startswith("labeled")
        ]
        if len(set(labeled_sizes)) > 1:
            # the weak and strong labeled views share ONE sampled batch
            # (strong is derived on device from weak)
            raise ValueError(
                f"labeled BATCH_RATIOS must be equal "
                f"(got per-stream sizes {labeled_sizes}): the weak and "
                f"strong labeled views are derived from one shared batch"
            )
        labeled_bs = max(labeled_sizes, default=0)
        unlabeled_bs = max(
            [s for c, s in zip(contents, sizes) if c.startswith("unlabeled")],
            default=0,
        )
        threads = num_threads or cfg.TPU.DATA_THREADS

        self.labeled = None
        if labeled_bs > 0 and len(cfg.DATASETS.TRAIN):
            self.labeled = StreamLoader(
                get_dataset_records(
                    cfg.DATASETS.TRAIN, cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS
                ),
                labeled_bs, cfg, canvas, True, seed, threads,
                cfg.TPU.PREFETCH,
            )
        self.unlabeled = None
        if unlabeled_bs > 0 and len(cfg.DATASETS.UNLABELED):
            self.unlabeled = StreamLoader(
                get_dataset_records(
                    cfg.DATASETS.UNLABELED,
                    cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS,
                ),
                unlabeled_bs, cfg, canvas, True, seed + 1, threads,
                cfg.TPU.PREFETCH,
            )
        self.canvas = canvas

    def seek(self, batch_idx: int):
        """Resume the deterministic batch stream at train iteration
        ``batch_idx`` (both streams advance one batch per iteration)."""
        if self.labeled is not None:
            self.labeled.seek(batch_idx)
        if self.unlabeled is not None:
            self.unlabeled.seek(batch_idx)

    def __iter__(self):
        return self

    def _empty_stream(self):
        ch, cw = self.canvas
        return {
            "image": np.zeros((0, ch, cw, 3), np.uint8),
            "sizes": np.zeros((0, 2), np.int32),
        }

    def __next__(self) -> dict:
        batch = {}
        if self.labeled is not None:
            batch["labeled"] = next(self.labeled)
        if self.unlabeled is not None:
            u = next(self.unlabeled)
            batch["unlabeled"] = {"image": u["image"], "sizes": u["sizes"]}
        else:
            batch["unlabeled"] = self._empty_stream()
        return batch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class DevicePrefetcher:
    """Copy host batches to the device ahead of the step that takes them.

    A daemon thread pulls numpy batches from ``loader`` and keeps up to
    ``depth`` of them on ``device`` (``cuda`` unless the caller asks for
    the CPU; raises without a GPU). On the card each array goes to pinned
    host memory and then, ``non_blocking``, to the device on a side CUDA
    stream, so the copy of the next batch runs under the current step. The
    consumer's stream waits for the copy's event before it uses the batch,
    and every tensor is ``record_stream``-ed on it, so the caching
    allocator never hands a batch's memory to another tensor while a step
    on the consumer's stream may still read it. An exception in the thread
    (a missing image, say) is raised in the consumer. On the CPU the
    arrays become tensors without a copy.
    """

    def __init__(self, loader, device=None, depth: int = 2):
        self.device = resolve_device(device)
        self._loader = loader
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, batch):
        if self._stream is None:
            return _map(batch, torch.from_numpy), None
        with torch.cuda.stream(self._stream):
            out = _map(batch, lambda a: torch.from_numpy(a).pin_memory().to(
                self.device, non_blocking=True))
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._put(next(self._loader))
            except Exception as e:  # surface in the consumer, not here
                self._q.put(("error", e))
                return
            while not self._stop.is_set():
                try:
                    self._q.put(("ok", item), timeout=0.1)
                    break
                except queue.Full:  # consumer paused (eval, checkpoint)
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        kind, item = self._q.get()
        if kind == "error":
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in _leaves(batch):
                t.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        # unblock a worker waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class TestLoader:
    """Sequential eval loader: yields (batch, metas) where metas carry
    image_id and the resize scale for mapping canvas boxes back to original
    image coordinates (done on the host by the evaluator)."""

    __test__ = False  # not a pytest class

    def __init__(self, dataset_name: str, cfg, canvas, batch_size: int = 8):
        self.records = DatasetCatalog.get(dataset_name)
        self.cfg = cfg
        self.canvas = tuple(canvas)
        self.batch_size = batch_size

    def __iter__(self):
        rng = np.random.default_rng(0)
        bs = self.batch_size
        for i in range(0, len(self.records), bs):
            chunk = self.records[i : i + bs]
            recs = [
                transform_record(
                    r, rng,
                    min_sizes=[self.cfg.INPUT.MIN_SIZE_TEST],
                    max_size=self.cfg.INPUT.MAX_SIZE_TEST,
                    canvas=self.canvas,
                    flip=False,
                    sampling="choice",
                    max_gt=self.cfg.TPU.MAX_GT,
                    bgr=self.cfg.INPUT.FORMAT.upper() == "BGR",
                    is_train=False,
                )
                for r in chunk
            ]
            npad = bs - len(recs)
            batch = {k: np.stack([r[k] for r in recs])
                     for k in ("image", "sizes")}
            if npad:
                batch = {
                    k: np.concatenate(
                        [v, np.zeros((npad,) + v.shape[1:], v.dtype)]
                    )
                    for k, v in batch.items()
                }
            metas = [
                {"image_id": r["image_id"], "scale": r["scale"]} for r in recs
            ]
            yield batch, metas
