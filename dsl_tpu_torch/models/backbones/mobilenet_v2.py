"""MobileNetV2 backbone, NCHW.

Counterpart of ``dsl_tpu/models/backbones/mobilenet_v2.py`` (mmdet's
``MobileNetV2``): a stride-2 3x3 stem, then the seven stages of inverted
residuals (a 1x1 expansion where the ratio is not 1, a depthwise 3x3, a
linear 1x1 projection; relu6 after the first two; the input added where
stride and width stay), widths scaled by ``widen_factor`` and rounded by
``make_divisible``; the stages in ``out_indices`` (of 0-6) come out. As in
the JAX package there is no final 1x1 conv to 1280 channels: an mmdet
checkpoint's ``conv2.*`` raises naming the key.

Submodule names are mmdet's: ``conv1.{conv,bn}``, ``layer{i}.{j}``'s
``expand_conv``, ``depthwise_conv`` and ``linear_conv`` (each
``.conv`` / ``.bn``). BN is FrozenBatchNorm. ``frozen_stages`` freezes the
stem and ``layer1..k`` (``layers.is_frozen``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    conv1x1, he_normal_, is_frozen, make_conv, make_norm)
from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.utils.torch_import import load_torch_backbone

# (expand_ratio, channels, num_blocks, stride) per stage
ARCH = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None):
    """``v`` rounded to a multiple of ``divisor``, at least ``min_value``
    and not below 90% of ``v``."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBN(nn.Module):
    """mmcv's ``ConvModule`` with a BN and the activation left to the
    caller: keeps mmdet's ``.conv`` / ``.bn`` names."""

    def __init__(self, conv: nn.Conv2d, norm_cfg: dict | None):
        super().__init__()
        self.conv = conv
        self.bn = make_norm(norm_cfg, conv.out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: int = 6, norm_cfg: dict | None = None):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand_conv = (ConvBN(conv1x1(in_channels, hidden), norm_cfg)
                            if expand_ratio != 1 else None)
        self.depthwise_conv = ConvBN(
            make_conv(None, hidden, hidden, 3, stride, groups=hidden), norm_cfg)
        self.linear_conv = ConvBN(conv1x1(hidden, out_channels), norm_cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x if self.expand_conv is None else F.relu6(self.expand_conv(x))
        out = self.linear_conv(F.relu6(self.depthwise_conv(out)))
        return x + out if self.use_res else out


@BACKBONES.register(name="MobileNetV2")
class MobileNetV2(nn.Module):
    def __init__(self, widen_factor: float = 1.0,
                 out_indices: Sequence[int] = (1, 2, 4, 6),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 norm_cfg: dict | None = None, pretrained: str | None = None):
        super().__init__()
        # norm_eval is accepted for config parity: BN is FrozenBatchNorm
        self.out_indices = tuple(out_indices)
        self.pretrained = pretrained
        ch = make_divisible(32 * widen_factor)
        self.conv1 = ConvBN(make_conv(None, 3, ch, 3, 2), norm_cfg)
        for i, (t, c, n, s) in enumerate(ARCH):
            out = make_divisible(c * widen_factor)
            blocks = []
            for j in range(n):
                blocks.append(InvertedResidual(ch, out, s if j == 0 else 1, t,
                                               norm_cfg))
                ch = out
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        for name, p in self.named_parameters():
            if is_frozen(name, frozen_stages):
                p.requires_grad_(False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        conv2 = sorted(k for k in state_dict if k.startswith(prefix + "conv2."))
        if conv2:
            raise KeyError(f"{conv2[:4]}: mmdet's final 1x1 conv; the JAX "
                           f"package's MobileNetV2 (and the port's) has none")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs (the JAX package's init), then the ``pretrained``
        checkpoint where one is set."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
        if self.pretrained:
            load_torch_backbone(self.pretrained, self)

    def forward(self, x: torch.Tensor):
        x = F.relu6(self.conv1(x))
        outs = []
        for i in range(len(ARCH)):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
