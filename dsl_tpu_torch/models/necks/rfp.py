"""DetectoRS's Recursive Feature Pyramid neck, NCHW.

Counterpart of ``dsl_tpu/models/necks/rfp.py``:

- ``ASPP``: four branches with relu, concatenated: a 1x1, a 3x3 at
  dilation 3, a 3x3 at dilation 6, and a 1x1 on the spatial mean,
  broadcast (mmdet's ``aspp.{i}``);
- ``RFP``: the FPN (its convs at the neck's top level, ``lateral_convs``
  and ``fpn_convs``, as mmdet's ``RFP`` extends ``FPN``), then
  ``rfp_steps - 1`` times: ``ASPP`` of P3-P5 fed to stages 2-4 of a second
  DetectoRS backbone (``rfp_modules.{i}``, not shared with the detector's)
  through its ``rfp_forward`` on the image, the same FPN on its outputs,
  and each level mixed with the previous one by one 1x1 gate shared by all
  levels (``rfp_weight``, zero at init): ``s * new + (1 - s) * old``,
  ``s = sigmoid(rfp_weight(new))``. Its input is ``(image, C2, ..., C5)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.models.necks.fpn import FPN
from dsl_tpu_torch.registry import MODELS, NECKS, build_from_cfg


class ASPP(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 64,
                 dilations: Sequence[int] = (1, 3, 6, 1)):
        super().__init__()
        self.dilations = tuple(dilations)
        self.aspp = nn.ModuleList(
            nn.Conv2d(in_channels, out_channels, 3 if d > 1 else 1,
                      padding=d if d > 1 else 0, dilation=d)
            for d in self.dilations)

    def init_weights(self, generator: torch.Generator | None = None):
        for conv in self.aspp:
            he_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for i, conv in enumerate(self.aspp):
            inp = (x.mean(dim=(2, 3), keepdim=True)
                   if i == len(self.aspp) - 1 else x)
            outs.append(F.relu(conv(inp)))
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, dim=1)


@NECKS.register
class RFP(FPN):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 rfp_steps: int = 2, aspp_out_channels: int = 64,
                 aspp_dilations: Sequence[int] = (1, 3, 6, 1),
                 rfp_backbone: dict | None = None, start_level: int = 0):
        super().__init__(in_channels=in_channels, out_channels=out_channels,
                         num_outs=num_outs, start_level=start_level)
        self.rfp_steps = rfp_steps
        self.rfp_modules = nn.ModuleList(
            build_from_cfg(dict(rfp_backbone), MODELS)
            for _ in range(rfp_steps - 1))
        self.rfp_aspp = ASPP(out_channels, aspp_out_channels, aspp_dilations)
        self.rfp_weight = nn.Conv2d(out_channels, 1, 1)

    def init_weights(self, generator: torch.Generator | None = None):
        super().init_weights(generator)
        for module in self.rfp_modules:
            module.init_weights(generator)
        self.rfp_aspp.init_weights(generator)
        nn.init.zeros_(self.rfp_weight.weight)
        nn.init.zeros_(self.rfp_weight.bias)

    def forward(self, inputs):
        """(image, C2, C3, C4, C5) -> the levels."""
        img = inputs[0]
        x = super().forward(tuple(inputs[1:]))
        for module in self.rfp_modules:
            rfp_feats = [self.rfp_aspp(x[i]) for i in range(1, 4)]
            x_idx = super().forward(module.rfp_forward(img, rfp_feats))
            new = []
            for ft, old in zip(x_idx, x):
                w = torch.sigmoid(self.rfp_weight(ft))
                new.append(w * ft + (1 - w) * old)
            x = tuple(new)
        return x
