"""The DAOD trainer: loop, schedule points, eval, checkpoints.

Port of ``aldi_tpu/engine/trainer.py:38-331`` (the reference's
``ALDITrainer``, ``aldi/trainer.py:140-246``), on one device or data
parallel over a process group, one rank per GPU. The hook system
collapses into explicit schedule points in one loop:

- the EMA update inside the step (``engine/train_step.py``);
- metrics written every ``WRITE_PERIOD`` iterations and at the first:
  the step's losses, ``images_per_sec`` over the write window,
  ``data_time`` and ``dispatch_time``; a non-finite ``total_loss`` raises
  ``FloatingPointError``. Metrics are read from the device only there, so
  the steps in between stay asynchronous;
- eval every TEST.EVAL_PERIOD on the teacher when EMA is on, with the
  best checkpoint per test set on bbox/AP50;
- a checkpoint every SOLVER.CHECKPOINT_PERIOD and at MAX_ITER;
- ``TPU.PROFILE_DIR``: iterations start+10 .. start+12 traced with
  ``torch.profiler``.

``MODEL.DEVICE`` picks the device: ``cpu`` is the CPU; anything else
(``cuda``, or the YAMLs' ``tpu``) is the card ``cuda:LOCAL_RANK``, and
raises without one. Iteration ``it`` makes all its random draws
(``draws``) from a ``torch.Generator`` on that device seeded from (SEED,
it), as the JAX trainer folds ``it`` into its key, so a resumed run draws
what an unbroken one would. The data stream is a function of (SEED, it)
too (``data/loader.py``).

Data parallelism (``parallel/mesh.py``): the trainer uses the process
group its caller made (``tools/train_net.py`` spawns one rank per GPU) or
joins the one ``torchrun``'s environment describes, and lays its W ranks
out as the JAX trainer lays out its mesh (``aldi_tpu/engine/trainer.py:
92-133``): D = W / TPU.MESH_MODEL data ranks of TPU.MESH_MODEL model ranks
each (``mesh.make_grid``), the state split over the model group
(tensor parallelism) and, with TPU.FSDP, over the data group
(``engine/train_step.py`` ``shard_for_grid``). SOLVER.IMS_PER_BATCH stays
the global batch (rescaled to D by SOLVER.REFERENCE_WORLD_SIZE, as the JAX
trainer rescales to its data axis); each data rank loads, draws and steps
on its share of it, the ranks of a model group on the same share, and the
step sums the gradients. The metrics are summed across the data ranks at
the write points only; rank 0 writes ``metrics.json``, the checkpoints
(world 1's full state dicts, gathered by every rank) and
``trainer_state.json``, and every rank waits for the write. Evaluation
shards the test set over the data ranks and gathers the predictions.
"""

import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import datasets  # noqa: F401  (dataset registrations)
from ..data import native
from ..data.loader import DevicePrefetcher, WeakStrongLoader
from ..models import build_detector
from ..parallel import mesh
from ..utils.events import EventStorage, build_writers, setup_logger
from ..utils.tracing import span, sync
from .checkpoint import Checkpointer
from .evaluator import inference_on_dataset
from .train_step import (create_train_state, draw_step, grad_accum,
                         make_train_step)

WRITE_PERIOD = 20


def auto_scale_workers(cfg, world_size: int):
    """When SOLVER.REFERENCE_WORLD_SIZE is set, rescale batch size, LR,
    schedule, and eval/checkpoint periods to the actual world size
    (detectron2's ``DefaultTrainer.auto_scale_workers``). Returns a new
    cfg."""
    old = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old == 0 or old == world_size:
        return cfg
    cfg = cfg.clone()
    scale = world_size / old
    cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale)) for s in cfg.SOLVER.STEPS)
    cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.CHECKPOINT_PERIOD = int(
        round(cfg.SOLVER.CHECKPOINT_PERIOD / scale)
    )
    cfg.SOLVER.REFERENCE_WORLD_SIZE = world_size
    return cfg


def _stream_sizes(cfg):
    """Each stream's global batch: SOLVER.IMS_PER_BATCH split by
    DATASETS.BATCH_RATIOS."""
    ratios = cfg.DATASETS.BATCH_RATIOS
    total = cfg.SOLVER.IMS_PER_BATCH
    return [int(total * r / sum(ratios)) for r in ratios]


def trainer_device(cfg, device=None) -> torch.device:
    """``device`` if given, else MODEL.DEVICE: ``cpu`` is the CPU, anything
    else the rank's card ``cuda:LOCAL_RANK`` (raises without one); a
    ``cuda`` without an index is the rank's card too."""
    if device is None:
        device = ("cpu" if str(cfg.MODEL.DEVICE).lower() == "cpu"
                  else "cuda")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", mesh.local_rank())
    return device


def _to_device(batch, device):
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    return torch.from_numpy(batch).to(device)


class ALDITrainer:
    def __init__(self, cfg, device=None):
        self.device = trainer_device(cfg, device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        mesh.init_from_env(self.device.type)
        self.logger = setup_logger(cfg.OUTPUT_DIR)
        mesh.check_grid(cfg)
        if mesh.world() > 1:
            mesh.make_grid(cfg.TPU.MESH_MODEL)
        # the reference's "world size" is the data width: a model group
        # shares one batch slice
        n_data, n_model = mesh.data_world(), mesh.model_world()
        cfg = auto_scale_workers(cfg, n_data)
        if not cfg.is_frozen():
            cfg.freeze()
        self.cfg = cfg
        if mesh.world() > 1:
            for c, n in zip(cfg.DATASETS.BATCH_CONTENTS, _stream_sizes(cfg)):
                if n % n_data:
                    raise ValueError(
                        f"stream {c} batch {n} not divisible by data-axis "
                        f"size {n_data}; adjust SOLVER.IMS_PER_BATCH or "
                        "TPU.MESH_*")
            self.logger.info(
                f"Mesh over {mesh.world()} devices: data={n_data}"
                + (f" x model={n_model} (Megatron MLP sharding)"
                   if n_model > 1 else "")
                + (" + FSDP weight/optimizer sharding"
                   if cfg.TPU.FSDP else ""))
        self.seed = cfg.SEED if cfg.SEED >= 0 else 42
        self.detector = build_detector(cfg, device=self.device,
                                       seed=self.seed)
        self.state = create_train_state(cfg, self.detector)
        self.step_fn = make_train_step(cfg, self.detector)

        self.loader = None  # built lazily (eval-only runs have no train data)
        self.checkpointer = Checkpointer(cfg.OUTPUT_DIR, self.logger)
        self.storage = EventStorage()
        self.writers = build_writers(
            cfg.OUTPUT_DIR, cfg.SOLVER.MAX_ITER, self.logger
        )
        self._best = {}

    # ------------------------------------------------------------ weights
    def resume_or_load(self, resume: bool = False):
        extra = self.checkpointer.resume_or_load(
            self.state, self.cfg.MODEL.WEIGHTS, resume,
            load_from_ema=self.cfg.EMA.ENABLED
            and self.cfg.EMA.LOAD_FROM_EMA_ON_START,
        )
        if resume and self.checkpointer.has_checkpoint():
            # restore best-AP50 bookkeeping so the resumed run does not
            # re-save a worse "best" on its first eval
            self._best = dict(extra.get("best_ap50", {}))

    # -------------------------------------------------------------- draws
    def draws(self, it: int, batch: dict) -> dict:
        """Every random draw of iteration ``it``, from a generator on the
        trainer's device seeded from (SEED, it): the global batch's, of
        which a rank keeps its share (``shard_draws``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed << 32) + it)
        n_l = batch["labeled"]["image"].shape[0] if "labeled" in batch else 0
        n_u = batch["unlabeled"]["image"].shape[0]
        return mesh.shard_draws(
            draw_step(gen, self.detector, mesh.global_batch(n_l),
                      mesh.global_batch(n_u)), grad_accum(self.cfg))

    # --------------------------------------------------------------- train
    def train(self):
        cfg = self.cfg
        if self.loader is None:
            self.loader = WeakStrongLoader(
                cfg, self.detector.canvas, seed=int(self.seed),
                shard=(mesh.data_rank(), mesh.data_world()))
        # every rank starts from rank 0's weights
        mesh.broadcast_state(self.state.student, self.state.teacher)
        start = self.state.step
        # exact resume: continue the deterministic (seed, batch index)
        # stream where the saved run stopped; unconditional, since the
        # prefetcher pulls ahead of the consumed position
        self.loader.seek(start)
        self.logger.info(f"Starting training from iteration {start}")
        self.logger.info("Host decoder: %s (%s)" % native.decoder())
        self.storage.iter = start

        depth = cfg.TPU.DEVICE_PREFETCH
        prefetcher = (DevicePrefetcher(self.loader, self.device, depth)
                      if depth > 0 else None)
        batches = prefetcher if prefetcher is not None else (
            _to_device(b, self.device) for b in self.loader)
        try:
            evaluated_now, last_results = self._loop(batches, start)
        finally:
            if prefetcher is not None:
                # stop the copy thread (before the trailing eval, or on an
                # error) so it does not keep staging batches
                prefetcher.close()
        if cfg.TEST.EVAL_PERIOD:
            # no second pass when the loop's last iteration evaluated
            if evaluated_now:
                return last_results
            return self._eval_and_track_best()
        return {}

    def _loop(self, batches, start):
        """Iterations start .. MAX_ITER - 1 with their schedule points.
        Returns (whether the last one evaluated, its results). In the
        ``TPU.PROFILE_DIR`` trace each iteration's wait for its batch is the
        range ``aldi/train/data``, its step ``aldi/train/step`` and the read
        of its metrics ``aldi/sync/metrics`` (``utils/tracing.py``)."""
        cfg = self.cfg
        max_iter = cfg.SOLVER.MAX_ITER
        profiler = None
        data_t0 = time.time()
        # throughput over the whole write window: a per-step time around
        # the synchronizing metric read would count the queued steps' wait
        win_t0, win_iters = time.time(), 0
        evaluated_now, last_results = False, {}
        for it in range(start, max_iter):
            with span("train/data"):
                batch = next(batches)
            data_time = time.time() - data_t0
            if cfg.TPU.PROFILE_DIR and mesh.is_main():
                # trace a 3-iteration window
                if it == start + 10:
                    profiler = torch.profiler.profile()
                    profiler.start()
                elif it == start + 13:
                    profiler = self._stop_profiler(profiler)

            t_disp = time.time()
            with span("train/step"):
                self.state, metrics = self.step_fn(self.state, batch,
                                                   self.draws(it, batch))
            dispatch_time = time.time() - t_disp
            win_iters += 1

            if (cfg.VIS_PERIOD and (it + 1) % cfg.VIS_PERIOD == 0
                    and mesh.is_main()):
                self._visualize(batch, it + 1)

            self.storage.iter = it + 1
            if (it + 1) % WRITE_PERIOD == 0 or it == start:
                with sync("metrics"):
                    host_metrics = {k: float(v) for k, v in
                                    mesh.reduce_metrics(metrics).items()}
                elapsed = time.time() - win_t0
                host_metrics["images_per_sec"] = (
                    cfg.SOLVER.IMS_PER_BATCH * win_iters / max(elapsed, 1e-9)
                )
                host_metrics["data_time"] = data_time
                host_metrics["dispatch_time"] = dispatch_time
                self.storage.put_scalars(**host_metrics)
                for w in self.writers:
                    w.write(self.storage)
                total = host_metrics.get("total_loss", 0.0)
                if not np.isfinite(total):
                    self._stop_profiler(profiler)
                    raise FloatingPointError(
                        f"Loss became {total} at iteration {it}"
                    )
                win_t0, win_iters = time.time(), 0

            next_it = it + 1
            evaluated_now = bool(
                cfg.TEST.EVAL_PERIOD and next_it % cfg.TEST.EVAL_PERIOD == 0
            )
            if evaluated_now:
                last_results = self._eval_and_track_best()
                win_t0, win_iters = time.time(), 0  # exclude eval time
            if (cfg.SOLVER.CHECKPOINT_PERIOD
                    and next_it % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                    ) or next_it == max_iter:
                self.checkpointer.save(
                    self.state, extra={"best_ap50": self._best}
                )
                win_t0, win_iters = time.time(), 0  # exclude ckpt time
            data_t0 = time.time()
        self._stop_profiler(profiler)
        return evaluated_now, last_results

    def _stop_profiler(self, profiler):
        """Stop a running trace and write it to TPU.PROFILE_DIR."""
        if profiler is None:
            return None
        profiler.stop()
        os.makedirs(self.cfg.TPU.PROFILE_DIR, exist_ok=True)
        path = os.path.join(self.cfg.TPU.PROFILE_DIR, "trace.json")
        profiler.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")
        return None

    def _visualize(self, batch, it):
        """VIS_PERIOD training-batch visualization: PNGs with gt boxes under
        OUTPUT_DIR/vis."""
        try:
            from PIL import Image, ImageDraw

            out_dir = os.path.join(self.cfg.OUTPUT_DIR, "vis")
            os.makedirs(out_dir, exist_ok=True)
            lab = {k: v.cpu().numpy() for k, v in batch["labeled"].items()}
            bgr = self.cfg.INPUT.FORMAT.upper() == "BGR"
            for i in range(min(2, lab["image"].shape[0])):
                arr = np.asarray(lab["image"][i], np.uint8)
                if bgr:
                    arr = arr[:, :, ::-1]
                img = Image.fromarray(np.ascontiguousarray(arr))
                d = ImageDraw.Draw(img)
                for b, v in zip(lab["boxes"][i], lab["valid"][i]):
                    if v:
                        d.rectangle([float(x) for x in b],
                                    outline=(255, 60, 60), width=2)
                img.save(os.path.join(out_dir, f"iter{it:06d}_{i}.png"))
        except Exception as e:  # visualization must never kill training
            self.logger.warning(f"visualization failed: {e}")

    # ---------------------------------------------------------------- eval
    def eval_module(self):
        """The teacher when EMA is on (reference ``aldi/trainer.py:177-180``),
        else the student."""
        if self.cfg.EMA.ENABLED and self.state.teacher is not None:
            return self.state.teacher
        return self.state.student

    def test(self, module=None):
        module = module or self.eval_module()
        results = {}
        for ds in self.cfg.DATASETS.TEST:
            results[ds] = inference_on_dataset(
                self.detector, ds, self.cfg, logger=self.logger,
                module=module)
        return results

    def _eval_and_track_best(self):
        results = self.test()
        for ds, res in results.items():
            self.storage.put_scalars(
                **{f"{ds}/{k}": v for k, v in res.items() if "bbox" in k}
            )
            ap50 = res.get("bbox/AP50", float("nan"))
            if np.isfinite(ap50) and ap50 > self._best.get(ds, -1.0):
                self._best[ds] = ap50
                self.checkpointer.save(
                    self.state, name=f"{ds}_model_best",
                    extra={"best_ap50": self._best},
                )
                self.logger.info(f"New best {ds} AP50 = {ap50:.2f}")
        return results
