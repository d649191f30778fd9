"""The train step (loss -> backward -> SGD -> EMA) and the eval step.

Counterpart of ``dsl_tpu/train/train_step.py:25-146``. The step runs eagerly
on the state's device: the DSL FCOS loss, its backward into the f32 master
parameters (frozen ones have ``requires_grad=False`` and get no gradient),
mmcv's SGD, then the EMA teacher, gated by
``step + 1 >= ema_start_iter and (step + 1) % ema_interval == 0`` on the
host-side step count. Metrics stay 0-d tensors on the device, so nothing in
a step waits for the card.

Data parallelism (the JAX package's step jitted over a mesh): with a
process group, each rank steps its shard of the global batch. The loss's
normalizers are summed over the ranks, so each rank's loss is its share of
the global loss; after backward the gradients are summed over the ranks
(``parallel.mesh.allreduce_grads``), so every rank clips the global
``grad_norm`` and applies the same SGD and EMA update; the logged losses
are summed over the ranks (the global batch's). The collectives are
enqueued on the stream and add no host sync. With no group nothing of
this runs.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from dsl_tpu_torch.models.detectors.single_stage import (
    detector_loss, detector_predict)
from dsl_tpu_torch.parallel.mesh import all_reduce_sum, allreduce_grads
from dsl_tpu_torch.train.train_state import TrainState, ema_update
from dsl_tpu_torch.utils.device import resolve_device


def _check_device(state: TrainState, device: torch.device):
    found = state.ema_ratio.device
    if found.type != device.type or (
            device.index is not None and found.index != device.index):
        raise ValueError(f"the train state lies on {found}, the step was "
                         f"made for {device}")


def make_train_step(detector: nn.Module, tx, ema_interval: int = 1,
                    ema_start_iter: int = 0, compute_dtype=None,
                    frozen_mask: dict | None = None,
                    device: str | torch.device = "cuda",
                    group=None) -> Callable:
    """Build ``train_step(state, batch, mark=None) -> metrics``.

    ``tx`` is the ``MMCVSGD`` the state's optimizer was made from. The
    detector's frozen parameters are those with ``requires_grad=False``
    (the backbone sets it from ``frozen_stages``): their gradients are
    never computed. ``frozen_mask`` (name -> bool, as
    ``frozen_backbone_mask`` gives it), where given, must name exactly
    those parameters, else ``ValueError``.
    ``compute_dtype=torch.bfloat16`` runs the forward in bf16 with f32
    master weights and f32 losses. The step updates ``state`` in place and
    returns ``loss_*``, ``loss`` and ``grad_norm`` (before clipping), 0-d
    tensors on the device. ``mark(name)``, where given, is called after each
    part of the step is enqueued: ``forward``, ``loss``, ``backward``,
    ``optimizer``, ``ema`` (a timing split can record a CUDA event there).
    The device is CUDA unless the caller asks for the CPU. ``group`` is the
    process group of data-parallel ranks (module docstring), None for one
    process.
    """
    device = resolve_device(device)
    trainable = [p for p in detector.parameters() if p.requires_grad]
    if frozen_mask is not None:
        differ = [n for n, p in detector.named_parameters()
                  if frozen_mask.get(n, False) == p.requires_grad]
        if differ:
            raise ValueError(f"frozen_mask disagrees with requires_grad on "
                             f"{len(differ)} parameters, e.g. {differ[0]}")

    def train_step(state: TrainState, batch: dict, mark=None) -> dict:
        if state.student is not detector:
            raise ValueError("the train state holds another detector")
        _check_device(state, device)
        mark = mark or (lambda _: None)
        state.optimizer.zero_grad(set_to_none=True)
        loss, log_vars = detector_loss(detector, batch, cur_iter=state.step,
                                       compute_dtype=compute_dtype, mark=mark,
                                       group=group)
        mark("loss")
        loss.backward()
        if group is not None:
            allreduce_grads(trainable, group)
            names = list(log_vars)
            log_vars = dict(zip(names, all_reduce_sum(
                torch.stack([log_vars[k] for k in names]), group).unbind()))
        mark("backward")
        grad_norm = tx.update(state.optimizer, state.opt_count)
        state.opt_count += 1
        mark("optimizer")
        step = state.step + 1
        if ema_interval > 0 and step >= ema_start_iter and step % ema_interval == 0:
            state.teacher_params = ema_update(
                state.teacher_params, dict(detector.named_parameters()),
                state.ema_ratio)
            state.ema_initialized = True
        mark("ema")
        state.step = step
        return {**log_vars, "grad_norm": grad_norm}

    return train_step


def make_eval_step(detector: nn.Module, test_cfg: dict | None = None,
                   use_teacher: bool = False,
                   device: str | torch.device = "cuda") -> Callable:
    """Build ``eval_step(state, images, img_shapes=None, scale_factors=None)
    -> (dets, labels, valid)``: ``detector_predict`` with the teacher's
    parameters when ``use_teacher`` (the reference's EMA validation), else
    the student's. It reaches the NMS kernel on the card."""
    device = resolve_device(device)

    def eval_step(state: TrainState, images, img_shapes=None,
                  scale_factors=None):
        _check_device(state, device)
        return detector_predict(
            detector, images, img_shapes=img_shapes,
            scale_factors=scale_factors, test_cfg=test_cfg, device=device,
            params=state.teacher_params if use_teacher else None)

    return eval_step
