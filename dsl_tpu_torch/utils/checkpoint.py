"""Save and load the port's ``TrainState`` and detector weights with
``torch.save``.

Counterpart of ``dsl_tpu/utils/checkpoint.py`` (orbax there). A train
checkpoint holds the student's state dict, the teacher's parameters, the
optimizer's state dict (its SGD momentum buffers), ``step``,
``opt_count``, ``ema_ratio``, ``ema_initialized`` and ``meta``. Loading
restores them into a state built for the same detector and optimizer, bit
for bit. A weights file (:func:`save_weights`) is a detector's plain state
dict. :func:`load_weights` reads either, or an mmdet-layout ``.pth``, into
a detector. The JAX package's orbax and npz checkpoints reach this layout
through ``tools/jax_checkpoint_to_torch.py``. Under data parallelism rank
0 saves (``SemiRunner.save_checkpoint``) and every rank loads the same
file onto its own card.
"""

from __future__ import annotations

import os

import torch
from torch import nn

from dsl_tpu_torch.train.train_state import TrainState
from dsl_tpu_torch.utils.torch_import import (
    load_into, state_dict_of, strip_prefix)


def _save(obj, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, meta: dict | None = None):
    _save(dict(
        student=state.student.state_dict(),
        teacher_params=state.teacher_params,
        optimizer=state.optimizer.state_dict(),
        step=state.step, opt_count=state.opt_count,
        ema_ratio=state.ema_ratio, ema_initialized=state.ema_initialized,
        meta=dict(meta or {})), path)


def save_weights(path: str, detector: nn.Module):
    """The detector's state dict, on the CPU, as a weights file."""
    _save({k: v.detach().cpu() for k, v in detector.state_dict().items()},
          path)


def load_weights(path: str, detector: nn.Module, ema: bool = True):
    """Load ``path`` into ``detector``: a train checkpoint (the teacher's
    parameters with ``ema``, else the student's, and the student's
    buffers), a weights file, or an mmdet-layout ``.pth`` (a ``state_dict``
    of ``backbone.``, ``neck.`` and ``bbox_head.`` keys, a ``module.``
    prefix stripped). Raises where a key of the detector is missing."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "student" in ckpt and "teacher_params" in ckpt:
        sd = dict(ckpt["student"])
        if ema:
            sd.update(ckpt["teacher_params"])
    else:
        sd = strip_prefix(state_dict_of(ckpt))
    missing, _ = load_into(detector, sd, str(path))
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} keys of the detector, "
                       f"e.g. {missing[:3]}")


def load_checkpoint(path: str, state: TrainState) -> tuple[TrainState, dict]:
    """Restore ``path`` into ``state`` (in place); returns (state, meta)."""
    device = state.ema_ratio.device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.student.load_state_dict(ckpt["student"])
    missing = set(state.teacher_params) ^ set(ckpt["teacher_params"])
    if missing:
        raise KeyError(f"checkpoint teacher differs in {sorted(missing)[:3]}")
    state.teacher_params = dict(ckpt["teacher_params"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    state.opt_count = int(ckpt["opt_count"])
    state.ema_ratio = ckpt["ema_ratio"]
    state.ema_initialized = bool(ckpt["ema_initialized"])
    return state, ckpt["meta"]
