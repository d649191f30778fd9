"""The C4 detectors' RoI heads: res5 per RoI and an average-pool bbox head.

Counterpart of ``dsl_tpu/models/roi_heads/shared_heads.py``:

- ``ResLayerSharedHead``: ResNet stage ``stage`` (res5 by default: 3
  bottlenecks of 512 planes, the first at stride 2) on each RoI's
  features, 14x14x1024 -> 7x7x2048, under mmdet's name ``layer{stage+1}``
  (its blocks ``layer4.i.conv1`` ... as a ResNet's), FrozenBN, the JAX
  package's bottleneck whatever the depth;
- ``BBoxHeadAvgPool``: the plain ``BBoxHead`` with ``with_avg_pool``: the
  mean over the RoI's positions, then ``fc_cls`` (C + 1) and ``fc_reg``
  (4C). Its ``in_channels`` is the RoI features' (1024, as the configs
  write it); the classifiers read the shared head's output, whose width
  ``build_two_stage_detector`` passes as ``fc_in_channels`` (2048 for res5).
  Everything after the classifiers (the samples' loss, the per-class
  decode, NMS) is the standard RoI head's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dsl_tpu_torch.models.backbones.resnet import Bottleneck
from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.models.roi_heads.standard_roi_head import _BBoxHead
from dsl_tpu_torch.registry import HEADS

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


@HEADS.register
class ResLayerSharedHead(nn.Module):
    def __init__(self, depth: int = 50, stage: int = 3, stride: int = 2,
                 dilation: int = 1, style: str = "pytorch",
                 norm_cfg: dict | None = None, in_channels: int | None = None):
        super().__init__()
        planes = 64 * 2 ** stage
        # the RoI features' width (the JAX blocks take it from their input;
        # build_two_stage_detector passes the bbox head's in_channels)
        inplanes = in_channels or planes * Bottleneck.expansion // 2
        blocks = [Bottleneck(inplanes if i == 0 else planes * Bottleneck.expansion,
                             planes, stride if i == 0 else 1, dilation, style,
                             norm_cfg)
                  for i in range(STAGE_BLOCKS[depth][stage])]
        self.layer_name = f"layer{stage + 1}"
        self.add_module(self.layer_name, nn.Sequential(*blocks))
        self.out_channels = planes * Bottleneck.expansion

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """(N, C, s, s) -> (N, 4 * planes, s / stride, s / stride)."""
        return getattr(self, self.layer_name)(roi_feats)


@HEADS.register
class BBoxHeadAvgPool(_BBoxHead):
    def __init__(self, num_classes: int = 80, in_channels: int = 1024,
                 roi_size: int = 14,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 with_reg: bool = True, fc_in_channels: int | None = None):
        super().__init__(num_classes, in_channels, roi_size,
                         fc_in_channels or in_channels, target_means,
                         target_stds, with_reg, False, "single", None, None,
                         False, None, True)
        self.shared_fcs = nn.ModuleList()

    def forward(self, roi_feats: torch.Tensor):
        """roi_feats (N, C, s, s) -> (cls_logits (N, C+1), deltas (N, 4C))."""
        return self._fcs(roi_feats.mean((2, 3)))
