"""PAFPN: the FPN with a bottom-up path aggregation, NCHW.

Counterpart of ``dsl_tpu/models/necks/pafpn.py``: 1x1 laterals and the
nearest top-down sum (the FPN's repeat-and-crop), a 3x3 conv per level,
then bottom-up: each level adds the stride-2 3x3 conv of the level below
(cropped to its size) and, but the first, goes through a further 3x3
conv. The extra levels are stride-2 3x3 convs even at
``add_extra_convs=False``, as the JAX package builds them (mmdet max-pools
there): the first reads the last backbone level used where
``add_extra_convs='on_input'``, else the last output, with a relu before
every one but the first where ``relu_before_extra_convs``.

Submodule names are mmdet's (``lateral_convs.i.conv``, ``fpn_convs.i.conv``,
``downsample_convs.i.conv``, ``pafpn_convs.i.conv``, ``pafpn_convs.i``
acting on level ``i + 1``); the extra convs continue ``fpn_convs``, which
an mmdet PAFPN at ``add_extra_convs=False`` lacks, so its checkpoint
raises on load naming them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.necks.fpn import _ConvModule, _upsample_nearest_2x
from dsl_tpu_torch.registry import NECKS


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> _ConvModule:
    return _ConvModule(nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2))


@NECKS.register
class PAFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool | str = False,
                 relu_before_extra_convs: bool = False):
        super().__init__()
        self.in_channels = list(in_channels)
        end = len(self.in_channels) if end_level == -1 else end_level
        self.start_level, self.end_level = start_level, end
        self.add_extra_convs = add_extra_convs
        self.relu_before_extra_convs = relu_before_extra_convs
        used = self.in_channels[start_level:end]
        n = len(used)
        self.lateral_convs = nn.ModuleList(_conv(c, out_channels, 1)
                                           for c in used)
        first = used[-1] if add_extra_convs == "on_input" else out_channels
        self.fpn_convs = nn.ModuleList(
            [_conv(out_channels, out_channels, 3) for _ in used]
            + [_conv(first if i == 0 else out_channels, out_channels, 3, 2)
               for i in range(num_outs - n)])
        self.downsample_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3, 2) for _ in range(n - 1))
        self.pafpn_convs = nn.ModuleList(
            _conv(out_channels, out_channels, 3) for _ in range(n - 1))

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, inputs):
        used = list(inputs[self.start_level:self.end_level])
        n = len(used)
        laterals = [lat(x) for lat, x in zip(self.lateral_convs, used)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_nearest_2x(
                laterals[i], laterals[i - 1].shape[2:])
        inter = [self.fpn_convs[i](laterals[i]) for i in range(n)]
        for i in range(n - 1):
            down = self.downsample_convs[i](inter[i])
            h, w = inter[i + 1].shape[2:]
            inter[i + 1] = inter[i + 1] + down[:, :, :h, :w]
        outs = [inter[0]] + [conv(t) for conv, t in
                             zip(self.pafpn_convs, inter[1:])]
        src = used[-1] if self.add_extra_convs == "on_input" else outs[-1]
        for i, extra in enumerate(self.fpn_convs[n:]):
            if i > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            src = extra(src)
            outs.append(src)
        return tuple(outs)
