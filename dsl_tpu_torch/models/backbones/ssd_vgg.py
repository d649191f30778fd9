"""SSD's VGG-16 backbone, NCHW.

Counterpart of ``dsl_tpu/models/backbones/ssd_vgg.py`` (``SSDVGG``,
``L2Norm``): the VGG-16 conv stack (2, 2, 3, 3, 3 convs with relu, 2x2/2
max pools in floor mode as the JAX package pools, so SSD300's conv4_3 map
is 37x37; pool5 3x3/1), fc6 / fc7 as a 3x3 conv of dilation 6 and a 1x1
conv (1024 channels), then the extra layers in (1x1, kxk) pairs; the
outputs are conv4_3 through an ``L2Norm`` (a learnable per-channel scale,
20 at init), fc7, and each pair's second conv. SSD512 has a fifth pair with
a final 4x4 kernel. Module names are the JAX package's (``conv4_3``,
``l2_norm``, ``conv6``, ``extra3``), so the weight bridge carries them
across by name.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import BACKBONES

VGG16_CFG = (2, 2, 3, 3, 3)     # convs per stage


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None):
    """flax's default conv init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class L2Norm(nn.Module):
    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)
        return x / n * self.weight[:, None, None]


@BACKBONES.register
class SSDVGG(nn.Module):
    def __init__(self, input_size: int = 300, depth: int = 16,
                 out_feature_indices: Sequence[int] = (22, 34),
                 extra_channels: Sequence[int] = (256, 512, 128, 256, 128,
                                                  256, 128, 256),
                 pretrained: str | None = None):
        super().__init__()
        if tuple(out_feature_indices) != (22, 34) or depth != 16:
            raise NotImplementedError(
                "SSDVGG taps conv4_3 and fc7 of VGG-16 "
                "(out_feature_indices=(22, 34), depth=16)")
        if pretrained:
            raise NotImplementedError("SSDVGG(pretrained=...) is not ported "
                                      "yet")
        self.conv_names = []
        cin, ch = 3, 64
        for stage, n in enumerate(VGG16_CFG):
            for i in range(n):
                name = f"conv{stage + 1}_{i + 1}"
                self.add_module(name, nn.Conv2d(cin, ch, 3, padding=1))
                self.conv_names.append(name)
                cin = ch
            if stage < 3:
                ch = min(ch * 2, 512)
        self.l2_norm = L2Norm(512)
        self.conv6 = nn.Conv2d(512, 1024, 3, padding=6, dilation=6)
        self.conv7 = nn.Conv2d(1024, 1024, 1)
        ec = tuple(extra_channels)
        if input_size == 512:
            if len(ec) == 8:
                ec = ec + (128, 256)
            strides, pads, kernels = \
                (2, 2, 2, 2, 1), (1, 1, 1, 1, 1), (3, 3, 3, 3, 4)
        else:
            strides, pads, kernels = (2, 2, 1, 1), (1, 1, 0, 0), (3, 3, 3, 3)
        cin = 1024
        self.extra_names = []
        for p, i in enumerate(range(0, len(ec), 2)):
            k = kernels[p]
            self.add_module(f"extra{i}", nn.Conv2d(cin, ec[i], 1))
            self.add_module(f"extra{i + 1}", nn.Conv2d(
                ec[i], ec[i + 1], k, stride=strides[p], padding=pads[p]))
            self.extra_names.append((f"extra{i}", f"extra{i + 1}"))
            cin = ec[i + 1]

    def init_weights(self, generator: torch.Generator | None = None):
        """flax's defaults: lecun-normal kernels, zero biases, the L2Norm
        scale at 20."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.l2_norm.weight, 20.0)

    def forward(self, x: torch.Tensor):
        outs = []
        names = iter(self.conv_names)
        for stage, n in enumerate(VGG16_CFG):
            for _ in range(n):
                x = F.relu(getattr(self, next(names))(x))
            if stage == 3:
                outs.append(self.l2_norm(x))          # conv4_3
            if stage < 4:
                x = F.max_pool2d(x, 2, 2)
            else:                                     # pool5: 3x3/1
                x = F.max_pool2d(x, 3, 1, padding=1)
        x = F.relu(self.conv6(x))
        x = F.relu(self.conv7(x))
        outs.append(x)
        for first, second in self.extra_names:
            x = F.relu(getattr(self, first)(x))
            x = F.relu(getattr(self, second)(x))
            outs.append(x)
        return tuple(outs)
