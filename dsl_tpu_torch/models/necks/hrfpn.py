"""HRFPN neck, NCHW.

Counterpart of ``dsl_tpu/models/necks/hrfpn.py`` (mmdet's ``HRFPN``):
every HRNet branch resized to branch 0's size by ``jax.image.resize``'s
bilinear (``ops/resize.py::resize_bilinear``: JAX's weights, a backward
that repeats on the card), concatenated, reduced by a 1x1 conv, then
``num_outs`` levels, level ``i`` pooled at window and stride ``2**i``
(average, counting no padding since there is none, or max where
``pooling_type='MAX'``; floor mode, as flax's VALID pools), each through a
3x3 conv. As in the JAX package there is no ``stride``: the levels sit at
branch 0's stride times 1, 2, 4, ... (4 to 64 on HRNet).

Submodule names are mmdet's: ``reduction_conv.conv``, ``fpn_convs.{i}.conv``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.models.necks.fpn import _ConvModule
from dsl_tpu_torch.ops.resize import resize_bilinear
from dsl_tpu_torch.registry import NECKS


@NECKS.register
class HRFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (18, 36, 72, 144),
                 out_channels: int = 256, num_outs: int = 5,
                 pooling_type: str = "AVG"):
        super().__init__()
        if pooling_type not in ("AVG", "MAX"):
            raise ValueError(f"HRFPN pooling_type {pooling_type!r}: AVG or MAX")
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        self.pooling_type = pooling_type
        self.reduction_conv = _ConvModule(
            nn.Conv2d(sum(in_channels), out_channels, 1))
        self.fpn_convs = nn.ModuleList(
            _ConvModule(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in range(num_outs))

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, feats):
        if len(feats) != len(self.in_channels):
            raise ValueError(f"HRFPN got {len(feats)} inputs for "
                             f"{len(self.in_channels)} in_channels")
        hw = feats[0].shape[2:]
        x = self.reduction_conv(torch.cat(
            [feats[0]] + [resize_bilinear(f, hw) for f in feats[1:]], dim=1))
        pool = F.avg_pool2d if self.pooling_type == "AVG" else F.max_pool2d
        return tuple(conv(pool(x, 2 ** i, 2 ** i) if i else x)
                     for i, conv in enumerate(self.fpn_convs))
