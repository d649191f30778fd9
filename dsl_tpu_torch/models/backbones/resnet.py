"""ResNet backbone (caffe and pytorch styles), NCHW.

Counterpart of ``dsl_tpu/models/backbones/resnet.py`` (mmdet's ``ResNet``)
in the form the DSL configs use: the 7x7 stem and a 3x3/2 max pool, then
``num_stages`` stages of ``BasicBlock`` (depths 18, 34) or ``Bottleneck``
(50, 101, 152) blocks; ``style='caffe'`` puts a bottleneck's stride on its
first 1x1 conv, ``'pytorch'`` on its 3x3. BN is FrozenBatchNorm
(``norm_eval``); the last norm of each block starts at zero
(``zero_init_residual``). The features of the stages in ``out_indices``
come out.

Submodule names are mmdet's (``conv1``, ``bn1``, ``layerS.B.convK``,
``layerS.B.bnK``, ``layerS.B.downsample.{0,1}``), so an mmdet or
torchvision checkpoint loads by name (``utils/torch_import.py``).
``frozen_stages`` sets ``requires_grad=False`` on the stem and the first
``frozen_stages`` stages (``layers.is_frozen``); ``pretrained`` is a
checkpoint that :meth:`ResNet.init_weights` loads after the random init.
ResNet-V1d (``deep_stem``, ``avg_down``), ResNeXt (``groups``,
``base_width``), deformable convs (``dcn``) and ``plugins`` are not ported
yet and raise.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    conv1x1, conv3x3, he_normal_, is_frozen, make_conv, make_norm,
    max_pool_3x3_s2)
from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.utils.torch_import import load_torch_backbone

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(inplanes: int, out: int, stride: int, norm_cfg) -> nn.Module:
    return nn.Sequential(conv1x1(inplanes, out, stride),
                         make_norm(norm_cfg, out))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, norm_cfg: dict | None = None,
                 zero_init_residual: bool = True):
        super().__init__()
        # as the JAX package builds it: the dilation on the second conv only
        self.conv1 = conv3x3(inplanes, planes, stride)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv3x3(planes, planes, 1, dilation)
        self.bn2 = make_norm(norm_cfg, planes, zero_init=zero_init_residual)
        self.downsample = (_downsample(inplanes, planes, stride, norm_cfg)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, style: str = "pytorch",
                 norm_cfg: dict | None = None,
                 zero_init_residual: bool = True):
        super().__init__()
        out = planes * self.expansion
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = conv1x1(inplanes, planes, s1)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = make_conv(None, planes, planes, 3, s2, dilation)
        self.bn2 = make_norm(norm_cfg, planes)
        self.conv3 = conv1x1(planes, out)
        self.bn3 = make_norm(norm_cfg, out, zero_init=zero_init_residual)
        self.downsample = (_downsample(inplanes, out, stride, norm_cfg)
                           if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register(name="ResNet")
class ResNet(nn.Module):
    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 style: str = "pytorch", frozen_stages: int = -1,
                 norm_eval: bool = True, norm_cfg: dict | None = None,
                 conv_cfg: dict | None = None, pretrained: str | None = None,
                 zero_init_residual: bool = True, stem_channels: int = 64,
                 base_channels: int = 64, groups: int = 1,
                 base_width: int = 64, dcn: dict | None = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 plugins: Sequence[dict] | None = None,
                 deep_stem: bool = False, avg_down: bool = False):
        super().__init__()
        # norm_eval is accepted for config parity: BN is FrozenBatchNorm
        unported = {"deep_stem": deep_stem, "avg_down": avg_down,
                    "groups": groups != 1, "base_width": base_width != 64,
                    "dcn": dcn is not None, "plugins": bool(plugins),
                    "conv_cfg": conv_cfg is not None}
        for name, used in unported.items():
            if used:
                raise NotImplementedError(f"ResNet({name}=...) is not ported "
                                          f"yet")
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for ResNet")
        kind, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.pretrained = pretrained
        self.conv1 = make_conv(None, 3, stem_channels, 7, stride=2)
        self.bn1 = make_norm(norm_cfg, stem_channels)
        inplanes = stem_channels
        self.stage_names = []
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            blocks = []
            for j in range(stage_blocks[i]):
                stride = strides[i] if j == 0 else 1
                if kind == "bottleneck":
                    block = Bottleneck(inplanes, planes, stride, dilations[i],
                                       style, norm_cfg, zero_init_residual)
                else:
                    block = BasicBlock(inplanes, planes, stride, dilations[i],
                                       norm_cfg, zero_init_residual)
                blocks.append(block)
                inplanes = planes * block.expansion
            name = f"layer{i + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
        for name, p in self.named_parameters():
            if is_frozen(name, frozen_stages):
                p.requires_grad_(False)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs (the JAX package's init), then the ``pretrained``
        checkpoint where one is set."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
        if self.pretrained:
            load_torch_backbone(self.pretrained, self)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2(x)
        outs = []
        for i, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
