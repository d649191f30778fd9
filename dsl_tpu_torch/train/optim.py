"""mmcv SGD and AdamW, their LR and momentum schedules and the
frozen-parameter mask, in torch.

Counterpart of ``dsl_tpu/train/optim.py``, the reference's optimizer
contract (mmcv ``DefaultOptimizerConstructor`` + ``OptimizerHook``):

- SGD, momentum 0.9, weight decay 1e-4 coupled (``g + wd * p`` enters the
  momentum buffer), as ``torch.optim.SGD`` does it; ``momentum_config``
  (mmcv's cyclic momentum) sets the momentum per update from the host's
  update count;
- AdamW (``type='AdamW'``, or ``'Adam'``, the same update with the weight
  decay defaulting to 0, the JAX package's choice where
  ``torch.optim.Adam`` would couple it): decoupled weight decay, bias
  correction from float32 powers of the betas, ``paramwise_cfg.custom_keys``
  lr multipliers matched by substring on the parameter's name parts;
  ``momentum_config`` with it raises, as in JAX;
- ``paramwise_cfg`` for SGD: biases that are not a norm's get lr x
  ``bias_lr_mult`` and decay x ``bias_decay_mult``;
- gradients clipped by their global norm (35) first, scaled by
  ``min(1, clip / (norm + 1e-6))`` as ``clip_grad_norm_`` does;
- LR: linear warmup, then the config's policy, read at the update count
  before it increments;
- frozen parameters take no update: they have ``requires_grad=False``
  (the backbone sets it from ``frozen_stages``) and are not in the
  optimizer.

:class:`MMCVSGD` and :class:`MMCVAdamW` are the recipes (the JAX package's
gradient transformations): ``init`` binds an optimizer to a module's
trainable parameters and ``update`` takes one step from the gradients they
hold, with no host sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
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


def build_momentum_schedule(base_momentum: float, policy: str = "cyclic",
                            target_ratio: Sequence[float] = (0.85 / 0.95, 1.0),
                            step_ratio_up: float = 0.4,
                            total_iters: int | None = None,
                            anneal_strategy: str = "cos"
                            ) -> Callable[[int], float]:
    """mmcv's ``CyclicMomentumUpdaterHook`` (``momentum_config``): from
    ``base`` to ``base * target_ratio[0]`` over the first ``step_ratio_up``
    of the run, then to ``base * target_ratio[1]``, each phase annealed by
    cosine (``end + 0.5 * (start - end) * (cos(pi * pct) + 1)``) or
    linearly. Returns ``schedule(count) -> momentum`` on the host."""
    if policy.lower() != "cyclic":
        raise ValueError(f"unknown momentum policy {policy}")
    if not total_iters:
        raise ValueError("momentum policy 'cyclic' needs total_iters")
    if anneal_strategy not in ("cos", "linear"):
        raise ValueError(f"unknown anneal_strategy {anneal_strategy}")
    hi, end = float(target_ratio[0]), float(target_ratio[1])

    def anneal(start: float, stop: float, pct: float) -> float:
        if anneal_strategy == "cos":
            return stop + 0.5 * (start - stop) * (math.cos(math.pi * pct) + 1.0)
        return start + (stop - start) * pct

    def schedule(step: int) -> float:
        prog = min(max(step / int(total_iters), 0.0), 1.0)
        if prog < step_ratio_up:
            ratio = anneal(1.0, hi, min(prog / step_ratio_up, 1.0))
        else:
            ratio = anneal(hi, end, min(max((prog - step_ratio_up)
                                            / (1.0 - step_ratio_up), 0.0), 1.0))
        return base_momentum * ratio

    return schedule


def _grads_and_norm(params: list, clip: float | None):
    """The parameters' gradients (zeros where none: JAX differentiates every
    trainable leaf, so one the loss does not reach has a zero gradient and
    still decays), clipped in place by their global norm; returns them and
    the norm before clipping, a 0-d tensor on their device."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    # sum of squares, not torch's norm kernel: on the CPU that sums in
    # f32 without cascading (3e-4 off over 5M elements)
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    if clip is not None:
        scale = torch.clamp(clip / (norm + 1e-6), max=1.0)
        torch._foreach_mul_(grads, scale)
    return grads, norm


@dataclasses.dataclass(frozen=True)
class MMCVSGD:
    """mmcv's SGD with paramwise bias multipliers and global-norm clipping.

    A parameter with ``requires_grad=False`` stays out of the optimizer.
    ``momentum`` is a number or ``schedule(count) -> momentum``
    (:func:`build_momentum_schedule`).
    """

    lr_schedule: Callable[[int], float]
    momentum: float | Callable[[int], float] = 0.9
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
                               momentum=self.momentum_at(0))

    def momentum_at(self, count: int) -> float:
        return self.momentum(count) if callable(self.momentum) else self.momentum

    @torch.no_grad()
    def update(self, optimizer: torch.optim.SGD, count: int) -> torch.Tensor:
        """One step from the gradients held by the optimizer's parameters,
        at LR ``lr_schedule(count)`` and momentum ``momentum_at(count)``.
        Returns the gradients' global norm before clipping, a 0-d tensor on
        their device (no host sync)."""
        params = [p for g in optimizer.param_groups for p in g["params"]]
        _, norm = _grads_and_norm(params, self.grad_clip_norm)
        lr, momentum = self.lr_schedule(count), self.momentum_at(count)
        for g in optimizer.param_groups:
            g["lr"] = lr * g["lr_mult"]
            g["momentum"] = momentum
        optimizer.step()
        return norm


class AdamWState(torch.optim.Optimizer):
    """The state of :class:`MMCVAdamW`: per parameter ``exp_avg`` and
    ``exp_avg_sq`` (JAX's ``mu`` and ``nu``), per group its ``lr_mult``; a
    ``torch.optim.Optimizer`` so that checkpoints save and load it. Its
    update is :meth:`MMCVAdamW.update`, not ``step``."""

    def __init__(self, param_groups):
        super().__init__(param_groups, dict(lr=0.0, lr_mult=1.0))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = dict(exp_avg=torch.zeros_like(p),
                                     exp_avg_sq=torch.zeros_like(p))

    def step(self, closure=None):
        raise NotImplementedError("AdamWState is updated by MMCVAdamW.update")


@dataclasses.dataclass(frozen=True)
class MMCVAdamW:
    """The JAX package's ``make_adamw``: torch-AdamW semantics (decoupled
    weight decay) with ``custom_keys`` lr multipliers and global-norm
    clipping. Per parameter, at update ``count`` (0-based):

    ``m = b1 * m + (1 - b1) * g``; ``v = b2 * v + ((1 - b2) * g) * g``;
    ``c1 = 1 - b1 ** (count + 1)`` and ``c2`` likewise, in float32;
    ``p += -(lr * mult) * ((m / c1) / (sqrt(v / c2) + eps) + wd * p)``,
    as foreach ops (no host sync)."""

    lr_schedule: Callable[[int], float]
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-4
    custom_lr_mults: dict = dataclasses.field(default_factory=dict)
    grad_clip_norm: float | None = None

    def lr_mult(self, name: str) -> float:
        """The first ``custom_keys`` entry found in a part of the dotted
        name (JAX matches the parts of the flax path), else 1."""
        parts = name.split(".")
        for key, mult in self.custom_lr_mults.items():
            if any(key in part for part in parts):
                return float(mult)
        return 1.0

    def init(self, module: nn.Module) -> AdamWState:
        groups: dict[float, list] = {}
        for name, p in module.named_parameters():
            if p.requires_grad:
                groups.setdefault(self.lr_mult(name), []).append(p)
        return AdamWState([dict(params=ps, lr_mult=m)
                           for m, ps in groups.items()])

    @torch.no_grad()
    def update(self, optimizer: AdamWState, count: int) -> torch.Tensor:
        """One step at LR ``lr_schedule(count)``; returns the gradients'
        global norm before clipping (0-d, on their device)."""
        b1, b2 = self.betas
        params = [p for g in optimizer.param_groups for p in g["params"]]
        grads, norm = _grads_and_norm(params, self.grad_clip_norm)
        m = [optimizer.state[p]["exp_avg"] for p in params]
        v = [optimizer.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
        g2 = torch._foreach_mul(grads, 1 - b2)
        torch._foreach_mul_(g2, grads)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, g2)
        n = np.float32(count + 1)
        c1 = float(np.float32(1) - np.float32(b1) ** n)
        c2 = float(np.float32(1) - np.float32(b2) ** n)
        step = torch._foreach_div(m, c1)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(step, den)
        if self.weight_decay:
            torch._foreach_add_(step, torch._foreach_mul(params, self.weight_decay))
        lr = self.lr_schedule(count)
        i = 0
        for group in optimizer.param_groups:
            k = len(group["params"])
            group["lr"] = lr * group["lr_mult"]
            torch._foreach_mul_(step[i:i + k], -group["lr"])
            torch._foreach_add_(group["params"], step[i:i + k])
            i += k
        return norm


def make_optimizer(base_lr_schedule: Callable[[int], float],
                   momentum: float | Callable[[int], float] = 0.9,
                   weight_decay: float = 1e-4,
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
    """The config's optimizer / optimizer_config / lr_config /
    momentum_config blocks -> (MMCVSGD or MMCVAdamW, lr schedule)."""
    optimizer_cfg = dict(optimizer_cfg or {})
    opt_type = optimizer_cfg.get("type", "SGD")
    if opt_type not in ("SGD", "Adam", "AdamW"):
        raise NotImplementedError(f"optimizer {opt_type}")
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
    if opt_type in ("Adam", "AdamW"):
        if momentum_config:
            raise NotImplementedError(
                "momentum_config with Adam/AdamW (beta1 scheduling) is not "
                "supported; use an SGD optimizer or drop momentum_config")
        custom = {k: v.get("lr_mult", 1.0) for k, v in
                  dict(pw.get("custom_keys", {}) or {}).items()}
        tx = MMCVAdamW(
            sched, betas=tuple(optimizer_cfg.get("betas", (0.9, 0.999))),
            eps=optimizer_cfg.get("eps", 1e-8),
            weight_decay=optimizer_cfg.get(
                "weight_decay", 0.0 if opt_type == "Adam" else 1e-4),
            custom_lr_mults=custom, grad_clip_norm=clip)
        return tx, sched
    momentum = optimizer_cfg.get("momentum", 0.9)
    if momentum_config:
        mc = dict(momentum_config)
        momentum = build_momentum_schedule(
            float(momentum), policy=mc.get("policy", "cyclic"),
            target_ratio=tuple(mc.get("target_ratio", (0.85 / 0.95, 1.0))),
            step_ratio_up=mc.get("step_ratio_up", 0.4),
            total_iters=total_iters,
            anneal_strategy=mc.get("anneal_strategy", "cos"))
    tx = make_optimizer(
        sched, momentum=momentum,
        weight_decay=optimizer_cfg.get("weight_decay", 1e-4),
        bias_lr_mult=pw.get("bias_lr_mult", 1.0),
        bias_decay_mult=pw.get("bias_decay_mult", 1.0),
        grad_clip_norm=clip)
    return tx, sched
