"""RegNet backbone, NCHW.

Counterpart of ``dsl_tpu/models/backbones/regnet.py`` (mmdet's
``RegNet``): the stage widths and depths from the quantized-linear rule
(``generate_regnet``, the JAX package's copy of pycls' rule with the
group-width adjustment), a 32-channel stride-2 3x3 stem with no max pool,
then four stages of bottlenecks with bottleneck ratio 1 whose 3x3 conv is
grouped (``groups = max(1, width // group_w)``), each stage's first block
strided, the shortcut a strided 1x1 conv and a norm where the block
changes stride or width. ``arch`` names one of ``ARCH_PARAMS``
(``regnetx_400mf`` ... ``regnetx_12gf``).

Submodule names are mmdet's (a ResNet's): ``conv1``, ``bn1``,
``layer{i}.{j}.conv{1,2,3}``, ``.bn{1,2,3}``, ``.downsample.{0,1}``. BN is
FrozenBatchNorm; ``frozen_stages`` freezes the stem and ``layer1..k``
(``layers.is_frozen``). ``dcn`` (with ``stage_with_dcn``) makes the 3x3
conv of those stages' blocks a deformable one with one offset group, as
the JAX package builds it (``ops/deform_conv.py``; it reads the ``dcn``
type and no ``deform_groups``; mmcv's ``conv2.conv_offset`` names); an
mmdet checkpoint's DCN offsets for a conv that is plain here raise
naming the key.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    conv1x1, conv3x3, he_normal_, is_frozen, make_conv, make_norm)
from dsl_tpu_torch.ops.deform_conv import DeformConv2dPack, dcn_pack
from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.utils.torch_import import load_torch_backbone

ARCH_PARAMS = {
    "regnetx_400mf": dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22),
    "regnetx_800mf": dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16),
    "regnetx_1.6gf": dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18),
    "regnetx_3.2gf": dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25),
    "regnetx_4.0gf": dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23),
    "regnetx_6.4gf": dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17),
    "regnetx_8.0gf": dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23),
    "regnetx_12gf": dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19),
}


def generate_regnet(w0, wa, wm, depth, group_w=1, q=8):
    """(stage widths, stage depths): the quantized-linear widths, each
    rounded to a multiple of its group width, runs of equal widths made
    stages."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = np.round(w0 * np.power(wm, ks) / q) * q
    adj = []
    for wv in widths.astype(int):
        g = min(group_w, int(wv))
        adj.append(int(round(wv / g) * g))
    sw, sd = [], []
    for wv in adj:
        if wv not in sw:
            sw.append(wv)
            sd.append(adj.count(wv))
    return sw, sd


def refuse_dcn_offsets(module: nn.Module, state_dict: dict, prefix: str):
    """Raise naming an mmdet checkpoint's deformable-conv offsets under
    ``prefix`` whose conv is a plain one in ``module`` (a backbone built
    without ``dcn`` at that stage): the offsets would be dropped."""
    deform = {f"{prefix}{name}." for name, m in module.named_modules()
              if isinstance(m, DeformConv2dPack)}
    offsets = sorted(k for k in state_dict
                     if k.startswith(prefix) and ".conv_offset." in k
                     and k.split("conv_offset.")[0] not in deform)
    if offsets:
        raise KeyError(f"{offsets[:4]}: a deformable convolution's offsets "
                       f"for a conv that is plain in this backbone (no dcn "
                       f"at its stage)")


class RegBlock(nn.Module):
    def __init__(self, inplanes: int, width: int, stride: int,
                 group_width: int, norm_cfg: dict | None = None,
                 dcn: dict | None = None):
        super().__init__()
        groups = max(1, width // group_width)
        self.conv1 = conv1x1(inplanes, width)
        self.bn1 = make_norm(norm_cfg, width)
        # the JAX package's RegBlock takes the dcn type alone: one offset
        # group whatever deform_groups says
        self.conv2 = (make_conv(None, width, width, 3, stride, groups=groups)
                      if dcn is None else
                      dcn_pack(dict(type=dcn.get("type", "DCNv2")), width,
                               width, stride, groups=groups))
        self.bn2 = make_norm(norm_cfg, width)
        self.conv3 = conv1x1(width, width)
        self.bn3 = make_norm(norm_cfg, width)
        self.downsample = (nn.Sequential(conv1x1(inplanes, width, stride),
                                         make_norm(norm_cfg, width))
                           if stride != 1 or inplanes != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register(name="RegNet")
class RegNet(nn.Module):
    def __init__(self, arch: str = "regnetx_3.2gf",
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (2, 2, 2, 2),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 norm_cfg: dict | None = None, pretrained: str | None = None,
                 dcn: dict | None = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4):
        super().__init__()
        # norm_eval is accepted for config parity: BN is FrozenBatchNorm
        p = ARCH_PARAMS[arch]
        widths, depths = generate_regnet(p["w0"], p["wa"], p["wm"],
                                         p["depth"], p["group_w"])
        if len(widths) != 4:
            raise ValueError(f"{arch}: {len(widths)} stages {widths}, not 4")
        self.out_indices = tuple(out_indices)
        self.pretrained = pretrained
        self.conv1 = conv3x3(3, 32, 2)
        self.bn1 = make_norm(norm_cfg, 32)
        inplanes = 32
        for i in range(4):
            blocks = []
            for j in range(depths[i]):
                blocks.append(RegBlock(
                    inplanes, widths[i], strides[i] if j == 0 else 1,
                    p["group_w"], norm_cfg,
                    dcn if dcn is not None and stage_with_dcn[i] else None))
                inplanes = widths[i]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        for name, param in self.named_parameters():
            if is_frozen(name, frozen_stages):
                param.requires_grad_(False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        refuse_dcn_offsets(self, state_dict, prefix)
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
        x = F.relu(self.bn1(self.conv1(x)))
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
