"""mmcv SGD, its LR schedule and the frozen-parameter mask, in torch.

Counterpart of ``dsl_tpu/train/optim.py`` (SGD branch), the reference's
optimizer contract (mmcv ``DefaultOptimizerConstructor`` + ``OptimizerHook``):

- SGD, momentum 0.9, weight decay 1e-4 coupled (``g + wd * p`` enters the
  momentum buffer), as ``torch.optim.SGD`` does it;
- ``paramwise_cfg``: biases that are not a norm's get lr x ``bias_lr_mult``
  and decay x ``bias_decay_mult``;
- gradients clipped by their global norm (35) first, scaled by
  ``min(1, clip / (norm + 1e-6))`` as ``clip_grad_norm_`` does;
- LR: linear warmup, then the config's policy, read at the update count
  before it increments;
- frozen parameters take no update: they have ``requires_grad=False``
  (the backbone sets it from ``frozen_stages``) and are not in the
  optimizer.

:class:`MMCVSGD` is the recipe (the JAX package's gradient transformation):
``init`` binds a ``torch.optim.SGD`` to a module's trainable parameters and
``update`` takes one step from the gradients they hold.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
from torch import nn

from dsl_tpu_torch.models.layers import FrozenBatchNorm, is_frozen

NORM_TYPES = (FrozenBatchNorm, nn.GroupNorm)


def is_norm_param(module: nn.Module, name: str) -> bool:
    """Whether parameter ``name`` of ``module`` belongs to a norm layer.

    By module type: the JAX package matches tokens (``bn``, ``gn``, ``norm``,
    ...) on its flax names, and the port's names differ (the downsample BN is
    ``downsample.1``); the two agree on every parameter of the flagship."""
    return isinstance(module.get_submodule(name.rpartition(".")[0]),
                      NORM_TYPES)


def is_bias_param(module: nn.Module, name: str) -> bool:
    return name.rpartition(".")[2] == "bias" and not is_norm_param(module, name)


def frozen_backbone_mask(module: nn.Module, frozen_stages: int,
                         backbone_key: str = "backbone") -> dict[str, bool]:
    """Parameter name -> True where it must not be updated (an RLA-ResNet
    backbone's ``frozen_stages``, see ``layers.is_frozen``)."""
    prefix = backbone_key + "."
    return {name: name.startswith(prefix)
            and is_frozen(name[len(prefix):], frozen_stages)
            for name, _ in module.named_parameters()}


def build_lr_schedule(base_lr: float, warmup_iters: int = 500,
                      warmup_ratio: float = 1.0 / 3.0,
                      step_epochs: Sequence[int] = (),
                      steps_per_epoch: int = 1,
                      gamma: float = 0.1,
                      policy: str = "step",
                      total_iters: int | None = None,
                      min_lr_ratio: float = 0.0,
                      power: float = 1.0) -> Callable[[int], float]:
    """mmcv lr policies with linear warmup: 'step', 'CosineAnnealing'
    (cosine from base to ``base * min_lr_ratio`` over ``total_iters``),
    'poly' and 'cyclic' (up to 10x base over the first 40%, down to 1e-4x
    after). Returns ``schedule(count) -> lr`` on the host."""
    boundaries = [int(e * steps_per_epoch) for e in step_epochs]
    pol = policy.lower()
    if pol not in ("step", "cosineannealing", "poly", "cyclic"):
        raise ValueError(f"unknown lr policy {policy}")
    if pol != "step" and not total_iters:
        raise ValueError(
            f"lr policy {policy!r} needs total_iters (pass total_epochs "
            "to build_optimizer_from_cfg — runner.max_epochs)")

    def schedule(step: int) -> float:
        if warmup_iters > 0:
            frac = min(max(step / warmup_iters, 0.0), 1.0)
            warm = base_lr * (warmup_ratio + (1 - warmup_ratio) * frac)
        else:
            warm = base_lr
        if pol == "step":
            return warm * gamma ** sum(step >= b for b in boundaries)
        prog = min(max(step / int(total_iters), 0.0), 1.0)
        if pol == "cosineannealing":
            decay = min_lr_ratio + (1.0 - min_lr_ratio) * 0.5 * (
                1.0 + math.cos(math.pi * prog))
        elif pol == "poly":
            decay = max((1.0 - prog) ** power, min_lr_ratio)
        elif prog < 0.4:
            decay = 1.0 + (10.0 - 1.0) * min(prog / 0.4, 1.0)
        else:
            decay = 10.0 + (1e-4 - 10.0) * min(max((prog - 0.4) / 0.6, 0.0),
                                               1.0)
        return warm * decay

    return schedule


@dataclasses.dataclass(frozen=True)
class MMCVSGD:
    """mmcv's SGD with paramwise bias multipliers and global-norm clipping.

    A parameter with ``requires_grad=False`` stays out of the optimizer.
    """

    lr_schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 1e-4
    bias_lr_mult: float = 2.0
    bias_decay_mult: float = 0.0
    grad_clip_norm: float | None = 35.0

    def init(self, module: nn.Module) -> torch.optim.SGD:
        """``torch.optim.SGD`` over the module's trainable parameters, in
        two groups (the biases that are not a norm's, and the rest), each
        with its ``lr_mult`` and its weight decay."""
        groups = {False: [], True: []}
        for name, p in module.named_parameters():
            if p.requires_grad:
                groups[is_bias_param(module, name)].append(p)
        param_groups = [
            dict(params=groups[bias], lr_mult=lr_mult,
                 weight_decay=self.weight_decay * wd_mult)
            for bias, lr_mult, wd_mult in (
                (False, 1.0, 1.0),
                (True, self.bias_lr_mult, self.bias_decay_mult))
            if groups[bias]]
        return torch.optim.SGD(param_groups, lr=self.lr_schedule(0),
                               momentum=self.momentum)

    @torch.no_grad()
    def update(self, optimizer: torch.optim.SGD, count: int) -> torch.Tensor:
        """One step from the gradients held by the optimizer's parameters,
        at LR ``lr_schedule(count)``. Returns the gradients' global norm
        before clipping, a 0-d tensor on their device (no host sync)."""
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for p in params:
            # JAX differentiates every trainable leaf: one the loss does not
            # reach has a zero gradient, and still decays
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        # sum of squares, not torch's norm kernel: on the CPU that sums in
        # f32 without cascading (3e-4 off over 5M elements)
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        if self.grad_clip_norm is not None:
            scale = torch.clamp(self.grad_clip_norm / (norm + 1e-6), max=1.0)
            torch._foreach_mul_(grads, scale)
        lr = self.lr_schedule(count)
        for g in optimizer.param_groups:
            g["lr"] = lr * g["lr_mult"]
        optimizer.step()
        return norm


def make_optimizer(base_lr_schedule: Callable[[int], float],
                   momentum: float = 0.9, weight_decay: float = 1e-4,
                   bias_lr_mult: float = 2.0, bias_decay_mult: float = 0.0,
                   grad_clip_norm: float | None = 35.0) -> MMCVSGD:
    return MMCVSGD(base_lr_schedule, momentum, weight_decay, bias_lr_mult,
                   bias_decay_mult, grad_clip_norm)


def build_optimizer_from_cfg(optimizer_cfg: dict,
                             optimizer_config: dict | None = None,
                             lr_config: dict | None = None,
                             steps_per_epoch: int = 1,
                             total_epochs: int | None = None,
                             momentum_config: dict | None = None):
    """The config's optimizer / optimizer_config / lr_config blocks ->
    (MMCVSGD, lr schedule). AdamW and ``momentum_config`` are not ported
    yet and raise."""
    optimizer_cfg = dict(optimizer_cfg or {})
    opt_type = optimizer_cfg.get("type", "SGD")
    if opt_type != "SGD":
        raise NotImplementedError(f"optimizer {opt_type} is not ported yet")
    if momentum_config:
        raise NotImplementedError("momentum_config is not ported yet")
    pw = dict(optimizer_cfg.get("paramwise_cfg", {}) or {})
    lrc = dict(lr_config or {})
    total_iters = None
    if total_epochs:
        total_iters = int(total_epochs) * max(steps_per_epoch, 1)
    sched = build_lr_schedule(
        optimizer_cfg.get("lr", 0.01),
        warmup_iters=lrc.get("warmup_iters", 0),
        warmup_ratio=lrc.get("warmup_ratio", 1.0),
        step_epochs=lrc.get("step", ()),
        steps_per_epoch=steps_per_epoch,
        gamma=lrc.get("gamma", 0.1),
        policy=lrc.get("policy", "step"),
        total_iters=total_iters,
        min_lr_ratio=lrc.get("min_lr_ratio", 0.0),
        power=lrc.get("power", 1.0))
    clip = None
    if optimizer_config and optimizer_config.get("grad_clip"):
        clip = optimizer_config["grad_clip"].get("max_norm", 35.0)
    tx = make_optimizer(
        sched, momentum=optimizer_cfg.get("momentum", 0.9),
        weight_decay=optimizer_cfg.get("weight_decay", 1e-4),
        bias_lr_mult=pw.get("bias_lr_mult", 1.0),
        bias_decay_mult=pw.get("bias_decay_mult", 1.0),
        grad_clip_norm=clip)
    return tx, sched
