"""Checkpoint save and restore, and reference-format weight import.

Port of ``aldi_tpu/engine/checkpoint.py:44-207``. A checkpoint is one torch
file, ``OUTPUT_DIR/model_{iter:07d}.pth``, in the reference ALDI layout
(``aldi/checkpoint.py:18-32``): ``model`` (the student's state dict),
``ema`` (the teacher's, keys prefixed ``model.``; each state dict holds the
module's buffers, so YOLO's BatchNorm running statistics, the student's
and the teacher's EMA of them, are saved and resumed with the weights, as
``aldi_tpu/engine/checkpoint.py:144-160`` saves ``model_state`` and
``ema_model_state``), ``optimizer``,
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

Under data parallelism (``parallel/mesh.py``) rank 0 writes the files and
every rank waits for them before it goes on; every rank loads them, onto
its own device. On the data x model grid the file is world 1's all the
same: every rank takes part in gathering the split parameters and their
optimizer moments (``mesh.full_state_dict``), rank 0 writes; a load cuts
world 1's tensors to the rank's parts (``mesh.local_state_dict``), so a
checkpoint moves between world 1, tensor parallelism and FSDP both ways.
"""

import json
import os
from typing import Optional

import torch

from ..parallel import mesh
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
        "best". Rank 0 writes; every rank waits for it."""
        name = name or f"model_{state.step:07d}"
        path = os.path.join(self.dir, f"{name}.pth")
        ckpt = {
            "model": mesh.full_state_dict(state.student),
            "optimizer": full_optimizer_state(state.optimizer),
            "iteration": state.step,
            "trainer_state": extra or {},
            "__author__": AUTHOR,
        }
        if state.teacher is not None:
            ckpt["ema"] = {_EMA_PREFIX + k: v for k, v in
                           mesh.full_state_dict(state.teacher).items()}
        if mesh.is_main():
            self._write(ckpt, path, name, extra)
        mesh.barrier()
        return path

    def _write(self, ckpt, path, name, extra):
        tmp = path + ".tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
        with open(os.path.join(self.dir, _EXTRA), "w") as f:
            json.dump(extra or {}, f)
        with open(os.path.join(self.dir, _LAST), "w") as f:
            f.write(name)
        if self.logger:
            self.logger.info(f"Saved checkpoint {path}")

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
        device = next(state.student.parameters()).device
        ckpt = torch.load(path, map_location=device, weights_only=True)
        load_full(state.student, ckpt["model"])
        if state.teacher is not None and "ema" in ckpt:
            load_full(state.teacher, _strip_ema_prefix(ckpt["ema"]))
        state.optimizer.load_state_dict(
            local_optimizer_state(state.optimizer, ckpt["optimizer"]))
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


def load_full(module: torch.nn.Module, full: dict) -> None:
    """World 1's state dict ``full`` into ``module``, cut to the rank's
    parts of its split parameters."""
    module.load_state_dict(mesh.local_state_dict(module, full))


def _optimizer_params(optimizer) -> list:
    """The optimizer's parameters in its ``state_dict`` index order."""
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` with each moment of a split parameter
    gathered into world 1's tensor (a collective, as
    ``mesh.full_state_dict``)."""
    sd = optimizer.state_dict()
    for i, p in enumerate(_optimizer_params(optimizer)):
        shard = mesh.shard_of(p)
        if shard is None or i not in sd["state"]:
            continue
        sd["state"][i] = {k: mesh.full_tensor(v, shard)
                          if isinstance(v, torch.Tensor)
                          and v.shape == p.shape else v
                          for k, v in sd["state"][i].items()}
    return sd


def local_optimizer_state(optimizer, full: dict) -> dict:
    """World 1's optimizer state dict ``full`` with each moment of a split
    parameter cut to the rank's part."""
    state = dict(full["state"])
    for i, p in enumerate(_optimizer_params(optimizer)):
        shard = mesh.shard_of(p)
        if shard is None or i not in state:
            continue
        state[i] = {k: mesh.local_part(v, shard)
                    if isinstance(v, torch.Tensor)
                    and tuple(v.shape) == shard.shape else v
                    for k, v in state[i].items()}
    return {**full, "state": state}


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
        sd, mesh.full_state_dict(state.student), logger,
        convert_layouts=not own)
    load_full(state.student, weights)
    if state.teacher is not None:
        load_full(state.teacher, weights)
