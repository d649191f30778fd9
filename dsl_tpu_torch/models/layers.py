"""Shared building blocks: convs, norms, scale.

Counterpart of the parts of ``dsl_tpu/models/layers.py`` that the ported
detectors use (``WSConv`` is mmcv's ``ConvWS2d``; ``NormedConv2d`` is the
JAX package's ``NormedConv``). Tensors are NCHW. Convolutions take explicit padding
``p = d*(k-1)//2`` (none for 1x1), which is what the JAX package passes to
``nn.Conv``, so the two frameworks pad alike at every stride.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """BatchNorm that always uses its stored statistics (``norm_eval=True``).

    ``weight``/``bias`` are parameters, ``running_mean``/``running_var``
    buffers (mmdet's names). The statistics fold into a scale and shift in
    float32, which then apply in the input's dtype, so a bf16 backbone stays
    bf16.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 zero_init: bool = False):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(num_features) if zero_init
                                   else torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv32 = self.weight.float() * torch.rsqrt(self.running_var.float()
                                                  + self.eps)
        shift32 = self.bias.float() - self.running_mean.float() * inv32
        return (x * inv32.to(x.dtype)[:, None, None]
                + shift32.to(x.dtype)[:, None, None])


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-5) as the JAX package builds it.

    flax computes the variance as E[x^2] - E[x]^2; ``F.group_norm`` takes two
    passes. The parity tests state the tolerance that follows.
    """

    def __init__(self, num_channels: int, num_groups: int = 32,
                 zero_init: bool = False):
        super().__init__(num_groups, num_channels, eps=1e-5)
        if zero_init:
            nn.init.zeros_(self.weight)


def make_norm(norm_cfg: dict | None, num_features: int,
              zero_init: bool = False) -> nn.Module:
    """'BN'/'SyncBN' -> FrozenBatchNorm, 'GN' -> GroupNorm. ``zero_init``
    zero-inits the affine scale (mmdet's ``zero_init_residual``)."""
    norm_cfg = norm_cfg or dict(type="BN")
    t = norm_cfg.get("type", "BN")
    if t in ("BN", "SyncBN"):
        return FrozenBatchNorm(num_features, zero_init=zero_init)
    if t == "GN":
        return GroupNorm(num_features, norm_cfg.get("num_groups", 32),
                         zero_init=zero_init)
    raise ValueError(f"unknown norm type {t}")


class Scale(nn.Module):
    """Learnable scalar multiplier (mmcv ``Scale``)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class WSConv(nn.Conv2d):
    """Weight-standardised convolution (mmcv ``ConvWS2d``, the JAX
    package's ``WSConv``): each output channel's kernel is standardised
    over (Cin/groups, kh, kw) before the convolution, with the unbiased
    std taken as ``sqrt(var + 1e-12)`` (so its gradient stays finite where
    a kernel has no spread) and ``eps`` 1e-5 added to it."""

    eps = 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        n = flat.shape[1]
        mean = flat.mean(dim=1, keepdim=True)
        var = (flat - mean).square().mean(dim=1, keepdim=True) \
            * (n / max(n - 1, 1))
        std = torch.sqrt(var + 1e-12)
        w = ((flat - mean) / (std + self.eps)).reshape(w.shape)
        return self._conv_forward(x, w.to(x.dtype), self.bias)


class NormedConv2d(nn.Module):
    """The Seesaw configs' normed mask predictor as the JAX package's
    ``NormedConv`` computes it: each output's weights divided by their L2
    norm over (in, kh, kw), each pixel's input by its L2 norm over the
    channels (1e-6 inside both square roots), the conv (padding k // 2),
    times ``tempearture``; no bias. mmdet's ``NormedConv2d`` has a bias and
    adds its eps outside the root: a checkpoint holding that bias raises
    naming the key."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, tempearture: float = 20.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.tempearture = float(tempearture)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if f"{prefix}bias" in state_dict:
            raise KeyError(f"{prefix}bias: the normed predictor has no bias "
                           f"(the JAX package's NormedConv; mmdet's "
                           f"NormedConv2d adds one)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        wn = w / torch.sqrt((w * w).sum(dim=(1, 2, 3), keepdim=True) + 1e-6)
        xn = x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-6)
        return F.conv2d(xn, wn, padding=self.kernel_size // 2) * self.tempearture


def is_ws(conv_cfg: dict | None) -> bool:
    return bool(conv_cfg) and conv_cfg.get("type") in ("ConvWS", "ConvWS2d")


def make_conv(conv_cfg: dict | None, in_channels: int, out_channels: int,
              kernel_size: int, stride: int = 1, dilation: int = 1,
              use_bias: bool = False, groups: int = 1) -> nn.Conv2d:
    """``nn.Conv2d`` with the JAX package's explicit padding, or
    :class:`WSConv` for ``conv_cfg=dict(type='ConvWS')``; another conv
    type raises (as mmcv's ``build_conv_layer`` does)."""
    if conv_cfg and not is_ws(conv_cfg):
        raise ValueError(f"unknown conv type {conv_cfg.get('type')!r}")
    p = dilation * (kernel_size - 1) // 2
    cls = WSConv if is_ws(conv_cfg) else nn.Conv2d
    return cls(in_channels, out_channels, kernel_size, stride=stride,
               padding=p, dilation=dilation, groups=groups, bias=use_bias)


def conv3x3(in_channels: int, out_channels: int, stride: int = 1,
            dilation: int = 1, use_bias: bool = False,
            conv_cfg: dict | None = None) -> nn.Conv2d:
    return make_conv(conv_cfg, in_channels, out_channels, 3, stride, dilation,
                     use_bias)


def conv1x1(in_channels: int, out_channels: int, stride: int = 1,
            use_bias: bool = False, conv_cfg: dict | None = None) -> nn.Conv2d:
    return make_conv(conv_cfg, in_channels, out_channels, 1, stride,
                     use_bias=use_bias)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with pad 1 (``MaxPool2d(3, 2, 1)``)."""
    return F.max_pool2d(x, 3, stride=2, padding=1)


def he_normal_(weight: torch.Tensor, generator: torch.Generator | None = None):
    """flax ``he_normal``: truncated normal, variance 2/fan_in (a grouped
    conv's fan-in is its group's)."""
    fan_in = weight[0].numel()
    # flax truncates at 2 std and rescales so the variance stays 2/fan_in
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def normal_init(module: nn.Module, std: float = 0.01, bias: float = 0.0,
                generator: torch.Generator | None = None):
    nn.init.normal_(module.weight, 0.0, std, generator=generator)
    if getattr(module, "bias", None) is not None:
        nn.init.constant_(module.bias, bias)


def bias_init_with_prob(prior_prob: float) -> float:
    """Focal-loss classifier bias: -log((1-p)/p)."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def is_frozen(name: str, frozen_stages: int) -> bool:
    """Whether the backbone parameter ``name`` is frozen, as
    ``dsl_tpu/train/optim.py:45-79`` reads the reference's ``_freeze_stages``:
    with ``frozen_stages >= 0`` the stem (``conv1``, ``bn1``); with
    ``frozen_stages = k`` also stages ``0..k-1``: an RLA-ResNet's with their
    ``conv_outs``, ``recurrent_convs`` and ``stage_bns``, a ResNet's
    ``layer1..layerk``; and always an RLA-ResNet's ``stage_bns.3.2``, the
    hidden-state BN after the last block, whose output nothing reads."""
    parts = name.split(".")
    if parts[:3] == ["stage_bns", "3", "2"]:
        return True
    if frozen_stages < 0:
        return False
    if parts[0] in ("conv1", "bn1"):
        return True
    if parts[0].startswith("layer"):
        return int(parts[0][len("layer"):]) <= frozen_stages
    return (parts[0] in ("stages", "conv_outs", "recurrent_convs", "stage_bns")
            and int(parts[1]) < frozen_stages)
