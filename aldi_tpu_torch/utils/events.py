"""Metric storage and writers.

A copy of ``aldi_tpu/utils/events.py``: ``EventStorage`` and the JSON
(``metrics.json``), terminal and TensorBoard writers the trainer installs.
TensorBoard is optional (gated on the import of
``torch.utils.tensorboard``). The logger is named ``aldi_tpu_torch``.
"""

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict


class EventStorage:
    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._window = window
        self._history = defaultdict(lambda: deque(maxlen=window))
        self._latest = {}

    def put_scalars(self, **scalars):
        for k, v in scalars.items():
            v = float(v)
            self._history[k].append(v)
            self._latest[k] = v

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def median(self, key: str) -> float:
        h = sorted(self._history[key])
        return h[len(h) // 2] if h else float("nan")

    def smoothed(self) -> Dict[str, float]:
        return {
            k: sum(h) / len(h) for k, h in self._history.items() if h
        }


class JSONWriter:
    """Appends one JSON line per write to metrics.json (substrate format)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter}
        rec.update(storage.latest())
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TerminalWriter:
    def __init__(self, max_iter: int, logger=None):
        self.max_iter = max_iter
        self.logger = logger or logging.getLogger("aldi_tpu_torch")
        self._t0 = time.time()
        self._last_iter = 0

    def write(self, storage: EventStorage):
        it = storage.iter
        sm = storage.smoothed()
        losses = "  ".join(
            f"{k}: {v:.4g}" for k, v in sorted(sm.items()) if "loss" in k
        )
        dt = (time.time() - self._t0) / max(it - self._last_iter, 1)
        self._t0, self._last_iter = time.time(), it
        extras = "  ".join(
            f"{k}: {v:.4g}" for k, v in sorted(sm.items())
            if "loss" not in k
        )
        self.logger.info(
            f"iter {it}/{self.max_iter}  {losses}  {extras}  "
            f"sec/iter: {dt:.3f}"
        )


class TensorBoardWriter:
    """Optional TensorBoard scalars (substrate installs one by default)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(log_dir=log_dir)

    def write(self, storage: EventStorage):
        for k, v in storage.latest().items():
            self._w.add_scalar(k, v, storage.iter)

    def close(self):
        self._w.close()


def build_writers(output_dir: str, max_iter: int, logger=None):
    writers = [
        JSONWriter(os.path.join(output_dir, "metrics.json")),
        TerminalWriter(max_iter, logger),
    ]
    try:
        writers.append(
            TensorBoardWriter(os.path.join(output_dir, "tensorboard"))
        )
    except ImportError:
        pass
    return writers


def setup_logger(output_dir: str = None, name: str = "aldi_tpu_torch"):
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "[%(asctime)s %(name)s]: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
