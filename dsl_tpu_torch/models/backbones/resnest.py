"""ResNeSt backbone (split-attention networks), NCHW.

Counterpart of ``dsl_tpu/models/backbones/resnest.py`` (mmdet's
``ResNeSt``): the deep stem (three 3x3 convs, ``stem_channels / 2``,
``/ 2`` and ``stem_channels`` wide, then the 3x3/2 max pool), then
bottlenecks whose 3x3 conv is a radix-``r`` split-attention conv: a conv
grouped ``groups * r`` ways gives ``r`` splits, laid out radix-major as
the JAX package reshapes them (``(r, C)``), their sum is pooled over the
map, two FCs (the JAX package's ``Dense`` layers, here 1x1 convs as
mmdet's) and an r-softmax over the splits weigh them. A strided block
runs its split-attention conv at stride 1 and pools after it (avd: a
3x3 average pool that counts the padding, as flax's), and pools its
shortcut at window and stride = stride before a 1x1 conv (avg-down; floor
mode, as flax's VALID pool, where mmdet rounds up: at a stage input of
odd size the two branches then differ in size and the sum raises, in both
packages).

Submodule names are mmdet's: ``stem.{0,1,3,4,6,7}``, ``layer{i}.{j}.conv1``,
``.bn1``, ``.conv2.{conv,norm0,fc1,norm1,fc2}``, ``.conv3``, ``.bn3``,
``.downsample.{1,2}`` (``downsample.0`` is the pool). BN is FrozenBatchNorm.
As the JAX package's, it takes no ``frozen_stages`` (nothing is frozen)
and no ``pretrained``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    conv1x1, he_normal_, make_conv, make_norm, max_pool_3x3_s2)
from dsl_tpu_torch.registry import BACKBONES

ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def avg_down(inplanes: int, out: int, stride: int, norm_cfg) -> nn.Sequential:
    """The avg-down shortcut under mmdet's names: ``0`` the pool (floor
    mode; an identity at stride 1), ``1`` the 1x1 conv, ``2`` the norm."""
    pool = nn.AvgPool2d(stride, stride) if stride != 1 else nn.Identity()
    return nn.Sequential(pool, conv1x1(inplanes, out), make_norm(norm_cfg, out))


class SplitAttentionConv(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 radix: int = 2, groups: int = 1, reduction_factor: int = 4,
                 norm_cfg: dict | None = None):
        super().__init__()
        self.radix = radix
        self.channels = channels
        inter = max(in_channels * radix // reduction_factor, 32)
        self.conv = make_conv(None, in_channels, channels * radix, 3, stride,
                              groups=groups * radix)
        self.norm0 = make_norm(norm_cfg, channels * radix)
        self.fc1 = nn.Conv2d(channels, inter, 1)
        self.norm1 = make_norm(norm_cfg, inter)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, c = self.radix, self.channels
        y = F.relu(self.norm0(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.reshape(b, r, c, h, w)
        gap = splits.sum(dim=1).mean(dim=(2, 3), keepdim=True)
        gap = F.relu(self.norm1(self.fc1(gap)))
        att = self.fc2(gap).reshape(b, r, c, 1, 1)
        att = torch.softmax(att, dim=1) if r > 1 else torch.sigmoid(att)
        return (splits * att).sum(dim=1)


class SABottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 radix: int = 2, groups: int = 1, base_width: int = 4,
                 avd: bool = True, norm_cfg: dict | None = None):
        super().__init__()
        width = (planes if groups == 1
                 else int(planes * (base_width / 64.0)) * groups)
        out = planes * self.expansion
        self.stride = stride
        self.avd = avd and stride > 1
        self.conv1 = conv1x1(inplanes, width)
        self.bn1 = make_norm(norm_cfg, width)
        self.conv2 = SplitAttentionConv(width, width,
                                        1 if self.avd else stride, radix,
                                        groups, norm_cfg=norm_cfg)
        self.conv3 = conv1x1(width, out)
        self.bn3 = make_norm(norm_cfg, out)
        self.downsample = (avg_down(inplanes, out, stride, norm_cfg)
                           if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.avd:
            y = F.avg_pool2d(y, 3, self.stride, 1)
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


@BACKBONES.register(name="ResNeSt")
class ResNeSt(nn.Module):
    def __init__(self, depth: int = 50, radix: int = 2, groups: int = 1,
                 base_width: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 stem_channels: int = 64, norm_cfg: dict | None = None):
        super().__init__()
        self.out_indices = tuple(out_indices)
        half = stem_channels // 2
        layers = []
        for cin, cout, stride in ((3, half, 2), (half, half, 1),
                                  (half, stem_channels, 1)):
            layers += [make_conv(None, cin, cout, 3, stride),
                       make_norm(norm_cfg, cout), nn.ReLU()]
        self.stem = nn.Sequential(*layers)
        inplanes, planes = stem_channels, 64
        self.stage_names = []
        for i, n in enumerate(ARCH[depth]):
            blocks = []
            for j in range(n):
                blocks.append(SABottleneck(
                    inplanes, planes, 2 if (i > 0 and j == 0) else 1, radix,
                    groups, base_width, norm_cfg=norm_cfg))
                inplanes = planes * SABottleneck.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.stage_names.append(f"layer{i + 1}")
            planes *= 2

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor):
        x = max_pool_3x3_s2(self.stem(x))
        outs = []
        for i, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
