"""Checkpoint save and restore, and reference-format weight import.

Port of ``aldi_tpu/engine/checkpoint.py:44-207``. A checkpoint is one torch
file, ``OUTPUT_DIR/model_{iter:07d}.pth``, in the reference ALDI layout
(``aldi/checkpoint.py:18-32``): ``model`` (the student's state dict),
``ema`` (the teacher's, keys prefixed ``model.``), ``optimizer``,
``iteration``, ``trainer_state`` (the best-AP50 map) and ``__author__``,
which marks the port's own files: their tensors are in the port's layouts
already (detectron2's zoo files carry the key too). ``last_checkpoint``
names the newest file and ``trainer_state.json`` repeats its
``trainer_state``.

``resume_or_load`` follows the reference: with ``resume`` and a checkpoint
in OUTPUT_DIR, everything comes back (student, teacher, optimizer buffers,
iteration); otherwise MODEL.WEIGHTS is loaded into the student, from the
file's ``ema`` entry first when ``EMA.LOAD_FROM_EMA_ON_START`` (the burn-in
-> DA handoff), and copied into the teacher. The JAX package's orbax
directories are not read.
"""

import json
import os
from typing import Optional

import torch

from .checkpoint_convert import (load_d2_pkl_state_dict, load_torch_state_dict,
                                 reference_state_dict_to_port)
from .train_step import TrainState

_LAST = "last_checkpoint"
_EXTRA = "trainer_state.json"
_EMA_PREFIX = "model."
AUTHOR = "aldi_tpu_torch"


def _strip_ema_prefix(sd: dict) -> dict:
    return {k[len(_EMA_PREFIX):] if k.startswith(_EMA_PREFIX) else k: v
            for k, v in sd.items()}


class Checkpointer:
    def __init__(self, output_dir: str, logger=None):
        self.dir = os.path.abspath(output_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.logger = logger

    # ----------------------------------------------------------- own files
    def save(self, state: TrainState, name: Optional[str] = None,
             extra: Optional[dict] = None) -> str:
        """Write ``name`` (``model_{step:07d}`` by default) ``.pth``;
        ``extra``: JSON-serializable trainer bookkeeping (the best-AP50
        map), kept so that a resumed run does not re-save a worse
        "best"."""
        name = name or f"model_{state.step:07d}"
        path = os.path.join(self.dir, f"{name}.pth")
        ckpt = {
            "model": state.student.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "iteration": state.step,
            "trainer_state": extra or {},
            "__author__": AUTHOR,
        }
        if state.teacher is not None:
            ckpt["ema"] = {_EMA_PREFIX + k: v
                           for k, v in state.teacher.state_dict().items()}
        tmp = path + ".tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.dir, _EXTRA), "w") as f:
            json.dump(extra or {}, f)
        with open(os.path.join(self.dir, _LAST), "w") as f:
            f.write(name)
        if self.logger:
            self.logger.info(f"Saved checkpoint {path}")
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.dir, _LAST))

    def latest_path(self) -> Optional[str]:
        p = os.path.join(self.dir, _LAST)
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return os.path.join(self.dir, f.read().strip() + ".pth")

    def load(self, path: str, state: TrainState) -> dict:
        """Restore everything of ``path`` into ``state`` in place: the
        student, the teacher, the optimizer's buffers and the step. Returns
        the file's ``trainer_state``."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.student.load_state_dict(ckpt["model"])
        if state.teacher is not None and "ema" in ckpt:
            state.teacher.load_state_dict(_strip_ema_prefix(ckpt["ema"]))
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["iteration"])
        return dict(ckpt.get("trainer_state", {}))

    # ------------------------------------------------- reference interop
    def resume_or_load(self, state: TrainState, weights: str, resume: bool,
                       load_from_ema: bool = True) -> dict:
        """If ``resume`` and a checkpoint exists in OUTPUT_DIR, restore
        everything and return its trainer state; else fresh-load
        ``weights`` (MODEL.WEIGHTS) into the model only and return {}."""
        if resume and self.has_checkpoint():
            path = self.latest_path()
            if self.logger:
                self.logger.info(f"Resuming from {path}")
            return self.load(path, state)
        if weights:
            load_reference_weights(state, weights, load_from_ema,
                                   self.logger)
        return {}


def load_reference_weights(state: TrainState, path: str,
                           load_from_ema: bool = True, logger=None) -> None:
    """Fresh-start weight loading from a reference-format file into
    ``state``'s student, copied into its teacher. Supports the port's own
    checkpoints and ALDI ``.pth`` files (``{model, ema}``; the EMA entry
    first when ``load_from_ema``), plain torch state dicts and detectron2
    zoo ``.pkl`` files."""
    own = False
    if path.endswith(".pkl"):
        sd = load_d2_pkl_state_dict(path)
    else:
        sd = load_torch_state_dict(path, logger)
        own = isinstance(sd, dict) and sd.get("__author__") == AUTHOR
        if isinstance(sd, torch.nn.Module):
            sd = sd.state_dict()
        if "model" in sd and isinstance(sd["model"], dict):
            if load_from_ema and isinstance(sd.get("ema"), dict):
                sd = _strip_ema_prefix(sd["ema"])
                if logger:
                    logger.info(f"Initializing from EMA weights in {path}")
            else:
                sd = sd["model"]
    weights = reference_state_dict_to_port(
        sd, state.student.state_dict(), logger, convert_layouts=not own)
    state.student.load_state_dict(weights)
    if state.teacher is not None:
        state.teacher.load_state_dict(weights)
