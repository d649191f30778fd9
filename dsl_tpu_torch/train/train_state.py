"""Train state: the student, the EMA teacher, the optimizer, the step.

Counterpart of ``dsl_tpu/train/train_state.py``. The student is the module
itself (its parameters are the f32 master weights); the teacher is a second
set of parameters, blended from the student's by :func:`ema_update`, and
shares the student's buffers (the frozen BN statistics). Host-side counters
(``step``, ``opt_count``) stay Python ints, so a train step never waits for
the card to read them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from dsl_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    student: nn.Module
    teacher_params: dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    ema_ratio: torch.Tensor          # 0-d f32 keep rate, on the card
    step: int = 0                    # global iteration counter
    opt_count: int = 0               # optimizer updates (the LR schedule's input)
    ema_initialized: bool = False    # has an EMA blend run?

    @property
    def student_variables(self) -> dict[str, torch.Tensor]:
        return {**dict(self.student.named_parameters()),
                **dict(self.student.named_buffers())}

    @property
    def teacher_variables(self) -> dict[str, torch.Tensor]:
        return {**self.teacher_params, **dict(self.student.named_buffers())}


def create_train_state(detector: nn.Module, tx, ema_ratio: float = 0.99,
                       device: str | torch.device = "cuda") -> TrainState:
    """Move the detector to ``device`` (CUDA unless the caller asks for the
    CPU), copy its parameters into the teacher, and bind ``tx`` (an
    ``MMCVSGD``) to its trainable parameters."""
    device = resolve_device(device)
    detector.to(device)
    teacher = {k: p.detach().clone() for k, p in detector.named_parameters()}
    return TrainState(
        student=detector, teacher_params=teacher, optimizer=tx.init(detector),
        ema_ratio=torch.tensor(ema_ratio, dtype=torch.float32, device=device))


@torch.no_grad()
def ema_update(teacher: dict[str, torch.Tensor],
               student: dict[str, torch.Tensor],
               keep_rate: torch.Tensor) -> dict[str, torch.Tensor]:
    """New teacher parameters ``t * keep + s * (1 - keep)``, computed as
    written (two products and a sum) for every name of ``teacher``."""
    names = list(teacher)
    t = [teacher[k] for k in names]
    s = [student[k].detach() for k in names]
    blended = torch._foreach_add(torch._foreach_mul(t, keep_rate),
                                 torch._foreach_mul(s, 1 - keep_rate))
    return dict(zip(names, blended))
