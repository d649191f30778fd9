"""Save and load the port's ``TrainState`` with ``torch.save``.

Counterpart of ``dsl_tpu/utils/checkpoint.py`` (orbax there). One file
holds the student's state dict, the teacher's parameters, the optimizer's
state dict (its SGD momentum buffers), ``step``, ``opt_count``,
``ema_ratio``, ``ema_initialized`` and ``meta``. Loading restores them into
a state built for the same detector and optimizer, bit for bit. The JAX
package's orbax and npz checkpoints are not read.
"""

from __future__ import annotations

import os

import torch

from dsl_tpu_torch.train.train_state import TrainState


def save_checkpoint(path: str, state: TrainState, meta: dict | None = None):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(
        student=state.student.state_dict(),
        teacher_params=state.teacher_params,
        optimizer=state.optimizer.state_dict(),
        step=state.step, opt_count=state.opt_count,
        ema_ratio=state.ema_ratio, ema_initialized=state.ema_initialized,
        meta=dict(meta or {})), tmp)
    os.replace(tmp, path)


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
