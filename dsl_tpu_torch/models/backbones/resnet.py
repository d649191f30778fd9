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

ResNeXt (``groups``, ``base_width``: a bottleneck's 3x3 is grouped and
``int(planes * base_width / 64) * groups`` wide) and ResNet-V1d
(``deep_stem``: three 3x3 convs, mmdet's ``stem.{0,1,3,4,6,7}``;
``avg_down``: the shortcut's stride taken by a floor-mode average pool
before ``downsample.{0,1}``, as the JAX package pools) are ported, as
is ``conv_cfg=dict(type='ConvWS')`` on every conv. As in the JAX package,
``frozen_stages`` does not freeze a deep stem. ``dcn`` (with
``stage_with_dcn``) makes the 3x3 conv of those stages' bottlenecks a
deformable one (``ops/deform_conv.py``: mmcv's ``conv2.weight`` and
``conv2.conv_offset``; DCNv2 modulated, ``deform_groups``, the stride on
it in pytorch style, grouped for ResNeXt); a BasicBlock with ``dcn``
raises, as in the JAX package (mmdet's asserts). ``plugins`` run in a
bottleneck, as the JAX package runs them: GCNet's ``ContextBlock`` and
``GeneralizedAttention`` (``models/layers.py``) at ``after_conv2`` (on the
relu'd 3x3 output) or ``after_conv3`` (on the last norm's output, before
the residual sum), in config order, in the stages their ``stages`` flags
pick. A plugin is named by mmcv's abbreviation plus its ``postfix``
(``context_block``, ``gen_attention_block``). Another position (the JAX
package never runs one), a plugin on a BasicBlock and another plugin type
raise.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    ContextBlock, GeneralizedAttention, conv1x1, conv3x3, he_normal_,
    is_frozen, is_ws, make_conv, make_norm, max_pool_3x3_s2)
from dsl_tpu_torch.ops.deform_conv import dcn_pack
from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.utils.torch_import import load_torch_backbone

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class _AvgDown(nn.Sequential):
    """V1d's shortcut: the average pool takes the stride (floor mode, as
    the JAX package's VALID pool), then the 1x1 conv at stride 1 and the
    norm (``downsample.{0,1}``, the names of the plain shortcut)."""

    def __init__(self, stride: int, conv: nn.Module, norm: nn.Module):
        super().__init__(conv, norm)
        self.stride = stride

    def forward(self, x):
        return super().forward(F.avg_pool2d(x, self.stride, self.stride))


def _downsample(inplanes: int, out: int, stride: int, norm_cfg,
                conv_cfg=None, avg_down: bool = False) -> nn.Module:
    if avg_down and stride != 1:
        return _AvgDown(stride, conv1x1(inplanes, out, 1, conv_cfg=conv_cfg),
                        make_norm(norm_cfg, out))
    return nn.Sequential(conv1x1(inplanes, out, stride, conv_cfg=conv_cfg),
                         make_norm(norm_cfg, out))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, norm_cfg: dict | None = None,
                 zero_init_residual: bool = True, conv_cfg: dict | None = None,
                 avg_down: bool = False):
        super().__init__()
        # as the JAX package builds it: the dilation on the second conv only
        self.conv1 = conv3x3(inplanes, planes, stride, conv_cfg=conv_cfg)
        self.bn1 = make_norm(norm_cfg, planes)
        self.conv2 = conv3x3(planes, planes, 1, dilation, conv_cfg=conv_cfg)
        self.bn2 = make_norm(norm_cfg, planes, zero_init=zero_init_residual)
        self.downsample = (_downsample(inplanes, planes, stride, norm_cfg,
                                       conv_cfg, avg_down)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


PLUGINS = {"ContextBlock": ("context_block", ContextBlock),
           "GeneralizedAttention": ("gen_attention_block",
                                    GeneralizedAttention)}
PLUGIN_POSITIONS = ("after_conv2", "after_conv3")


def stage_plugins(plugins, stage: int) -> list[dict]:
    """The plugin entries of ``plugins`` whose ``stages`` flags (all
    stages where absent) pick ``stage``; a position the JAX package does
    not run raises."""
    picked = []
    for p in plugins or ():
        position = p.get("position", "after_conv3")
        if position not in PLUGIN_POSITIONS:
            raise NotImplementedError(
                f"plugins at {position!r}: the JAX package runs them only "
                f"{' and '.join(PLUGIN_POSITIONS)}")
        if tuple(p.get("stages", (True,) * 4))[stage]:
            picked.append(dict(p))
    return picked


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, style: str = "pytorch",
                 norm_cfg: dict | None = None,
                 zero_init_residual: bool = True, groups: int = 1,
                 base_width: int = 64, conv_cfg: dict | None = None,
                 avg_down: bool = False, dcn: dict | None = None,
                 plugins: list[dict] | None = None):
        super().__init__()
        out = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = conv1x1(inplanes, width, s1, conv_cfg=conv_cfg)
        self.bn1 = make_norm(norm_cfg, width)
        # the JAX package's deformable conv2 ignores conv_cfg (no ConvWS)
        self.conv2 = (make_conv(conv_cfg, width, width, 3, s2, dilation,
                                groups=groups) if dcn is None else
                      dcn_pack(dcn, width, width, s2, dilation, groups))
        self.bn2 = make_norm(norm_cfg, width)
        self.conv3 = conv1x1(width, out, conv_cfg=conv_cfg)
        self.bn3 = make_norm(norm_cfg, out, zero_init=zero_init_residual)
        self.downsample = (_downsample(inplanes, out, stride, norm_cfg,
                                       conv_cfg, avg_down)
                           if stride != 1 or inplanes != out else None)
        self.plugin_names = {pos: [] for pos in PLUGIN_POSITIONS}
        for p in plugins or ():
            cfg = dict(p["cfg"])
            kind = cfg.pop("type")
            if kind not in PLUGINS:
                raise NotImplementedError(f"plugin {kind} is not ported: "
                                          f"only {', '.join(PLUGINS)}")
            abbr, cls = PLUGINS[kind]
            name = abbr + str(p.get("postfix", ""))
            if hasattr(self, name):
                raise ValueError(f"duplicate plugin {name}")
            position = p.get("position", "after_conv3")
            self.add_module(name, cls(width if position == "after_conv2"
                                      else out, **cfg))
            self.plugin_names[position].append(name)

    def _plugins(self, x: torch.Tensor, position: str) -> torch.Tensor:
        for name in self.plugin_names[position]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self._plugins(out, "after_conv2")
        out = self._plugins(self.bn3(self.conv3(out)), "after_conv3")
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
        if conv_cfg and not is_ws(conv_cfg):
            raise NotImplementedError("ResNet(conv_cfg=...) is not ported yet")
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"invalid depth {depth} for ResNet")
        kind, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.pretrained = pretrained
        if deep_stem:
            half = stem_channels // 2
            layers = []
            for cin, cout, stride in ((3, half, 2), (half, half, 1),
                                      (half, stem_channels, 1)):
                layers += [make_conv(conv_cfg, cin, cout, 3, stride),
                           make_norm(norm_cfg, cout), nn.ReLU()]
            self.stem = nn.Sequential(*layers)
        else:
            self.conv1 = make_conv(conv_cfg, 3, stem_channels, 7, stride=2)
            self.bn1 = make_norm(norm_cfg, stem_channels)
        self.deep_stem = deep_stem
        inplanes = stem_channels
        self.stage_names = []
        widths = []
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            blocks = []
            stage_dcn = dcn if dcn is not None and stage_with_dcn[i] else None
            if stage_dcn is not None and kind != "bottleneck":
                raise NotImplementedError(
                    "dcn on BasicBlock (depth<50) is not supported (mmdet "
                    "parity: BasicBlock asserts dcn is None)")
            picked = stage_plugins(plugins, i)
            if picked and kind != "bottleneck":
                raise NotImplementedError("plugins on a BasicBlock are not "
                                          "supported (as in the JAX package)")
            for j in range(stage_blocks[i]):
                stride = strides[i] if j == 0 else 1
                if kind == "bottleneck":
                    block = Bottleneck(inplanes, planes, stride, dilations[i],
                                       style, norm_cfg, zero_init_residual,
                                       groups, base_width, conv_cfg, avg_down,
                                       stage_dcn, picked)
                else:
                    block = BasicBlock(inplanes, planes, stride, dilations[i],
                                       norm_cfg, zero_init_residual, conv_cfg,
                                       avg_down)
                blocks.append(block)
                inplanes = planes * block.expansion
            name = f"layer{i + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            widths.append(inplanes)
        # the widths of the levels that come out (the necks that, as flax
        # does, read their input widths from the levels: models/necks/
        # channel_mapper.py::build_neck)
        self.out_channels = tuple(widths[i] for i in self.out_indices)
        for name, p in self.named_parameters():
            if is_frozen(name, frozen_stages):
                p.requires_grad_(False)

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs (the JAX package's init), then the ``pretrained``
        checkpoint where one is set."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
        for m in self.modules():
            if isinstance(m, (ContextBlock, GeneralizedAttention)):
                m.init_weights(generator)
        if self.pretrained:
            load_torch_backbone(self.pretrained, self)

    def forward(self, x: torch.Tensor):
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3x3_s2(x)
        outs = []
        for i, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register(name="ResNetV1d")
class ResNetV1d(ResNet):
    """ResNet-V1d: the deep 3x3 stem and average-pool shortcuts."""

    def __init__(self, **kwargs):
        kwargs.setdefault("deep_stem", True)
        kwargs.setdefault("avg_down", True)
        super().__init__(**kwargs)


@BACKBONES.register(name="ResNeXt")
class ResNeXt(ResNet):
    """ResNeXt: grouped, widened bottlenecks (32x4d by default)."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
