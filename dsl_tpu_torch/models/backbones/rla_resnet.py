"""RLA-ResNet: ResNet with Recurrent Layer Aggregation, NCHW.

Counterpart of ``dsl_tpu/models/backbones/rla_resnet.py``. A
``rla_channel``-wide hidden state ``h`` (zeros at stem resolution) is
concatenated to every bottleneck's input; after each block, the block's
residual-branch output ``y`` folds back into ``h`` through the stage's
shared 1x1 ``conv_out``, ``+=``, the block's own ``stage_bn``, ``tanh`` and
the stage's shared 3x3 ``recurrent_conv``; ``h`` is 2x2 average-pooled when
the block strides.

Submodule names are the reference RLA checkpoint's (``stages.S.B.convK``,
``downsample.{0,1}``, ``conv_outs.S``, ``recurrent_convs.S``,
``stage_bns.S.B``), the names ``dsl_tpu/utils/torch_import.py`` reads.

``frozen_stages`` sets ``requires_grad=False`` on the parameters that
``layers.is_frozen`` names; ``pretrained`` is a checkpoint that
:meth:`RLAResNet.init_weights` loads after the random init.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.models.layers import (
    conv1x1, conv3x3, he_normal_, is_frozen, make_norm, max_pool_3x3_s2)
from dsl_tpu_torch.utils.torch_import import load_torch_backbone


class RLABottleneck(nn.Module):
    """Bottleneck over concat(x, h); returns (out, y, h_pooled)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, rla_channel: int,
                 stride: int = 1, has_downsample: bool = False,
                 norm_cfg: dict | None = None, zero_init_last_bn: bool = True):
        super().__init__()
        out_planes = planes * self.expansion
        self.stride = stride
        self.conv1 = conv1x1(inplanes + rla_channel, planes)
        self.bn1 = make_norm(norm_cfg, planes)
        # torchvision style: the stride sits on the 3x3
        self.conv2 = conv3x3(planes, planes, stride)
        self.bn2 = make_norm(norm_cfg, planes)
        self.conv3 = conv1x1(planes, out_planes)
        self.bn3 = make_norm(norm_cfg, out_planes, zero_init=zero_init_last_bn)
        self.downsample = (nn.Sequential(conv1x1(inplanes, out_planes, stride),
                                         make_norm(norm_cfg, out_planes))
                           if has_downsample else None)

    def forward(self, x: torch.Tensor, h: torch.Tensor):
        out = torch.cat([x, h], dim=1)
        out = F.relu(self.bn1(self.conv1(out)))
        out = F.relu(self.bn2(self.conv2(out)))
        y = self.bn3(self.conv3(out))
        identity = x
        if self.downsample is not None:
            identity = self.downsample(x)
            if self.stride != 1:
                h = F.avg_pool2d(h, 2, stride=2)
        return F.relu(y + identity), y, h


@BACKBONES.register(name="RLA_ResNet")
class RLAResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 rla_channel: int = 32, SE: bool = False,
                 ECA: Sequence[int] | None = None, frozen_stages: int = -1,
                 norm_eval: bool = True, style: str = "pytorch",
                 norm_cfg: dict | None = None, pretrained: str | None = None,
                 num_classes: int = 1000, zero_init_last_bn: bool = True):
        super().__init__()
        # norm_eval / style / num_classes are accepted for config parity, as
        # in the JAX package: BN is FrozenBatchNorm, the stride sits on the
        # 3x3 whatever the style, and there is no classifier.
        if SE or ECA is not None:
            raise NotImplementedError("RLA-ResNet with SE/ECA is not ported yet")
        self.pretrained = pretrained
        self.rla_channel = rla_channel
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = make_norm(norm_cfg, 64)
        self.stages = nn.ModuleList()
        self.conv_outs = nn.ModuleList()
        self.recurrent_convs = nn.ModuleList()
        self.stage_bns = nn.ModuleList()
        inplanes = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            stride0 = 1 if stage == 0 else 2
            blocks = nn.ModuleList()
            for blk in range(n_blocks):
                stride = stride0 if blk == 0 else 1
                has_ds = blk == 0 and (stride != 1
                                       or inplanes != planes * 4)
                blocks.append(RLABottleneck(
                    inplanes, planes, rla_channel, stride, has_ds, norm_cfg,
                    zero_init_last_bn))
                inplanes = planes * 4
            self.stages.append(blocks)
            # shared per stage, as the reference's `_make_layer` builds them
            self.conv_outs.append(conv1x1(inplanes, rla_channel))
            self.recurrent_convs.append(conv3x3(rla_channel, rla_channel))
            self.stage_bns.append(nn.ModuleList(
                make_norm(norm_cfg, rla_channel) for _ in range(n_blocks)))
        for name, p in self.named_parameters():
            if is_frozen(name, frozen_stages):
                p.requires_grad_(False)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs, then the ``pretrained`` checkpoint (the RLA
        ImageNet ``.pth.tar``) where one is set."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
        if self.pretrained:
            load_torch_backbone(self.pretrained, self)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2(x)
        b, _, hh, ww = x.shape
        h = x.new_zeros((b, self.rla_channel, hh, ww))
        outs = []
        for blocks, conv_out, recurrent_conv, bns in zip(
                self.stages, self.conv_outs, self.recurrent_convs,
                self.stage_bns):
            for block, bn in zip(blocks, bns):
                x, y, h = block(x, h)
                h = recurrent_conv(torch.tanh(bn(h + conv_out(y))))
            outs.append(x)
        return tuple(outs)

