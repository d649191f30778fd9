"""Res2Net backbone, NCHW.

Counterpart of ``dsl_tpu/models/backbones/res2net.py``: the JAX package's
7x7 stem and 3x3/2 max pool (mmdet's Res2Net has a deep stem), then
``Bottle2neck`` blocks: the 1x1 conv's output split into ``scales``
groups of ``int(planes * base_width / 64)`` channels, a cascade of 3x3
convs over the first ``scales - 1`` (each adding the previous conv's
output to its split, except in a stage's first block, where each reads
its own split at the block's stride), the last split passed on (average
pooled 3x3 with the padding counted where the block is strided, as
flax's), then the 1x1 conv. The shortcut pools at window and stride =
stride (floor mode, as flax's VALID pool) before its 1x1 conv: at a stage
input of odd size the two branches differ in size and the sum raises, in
both packages.

Submodule names are mmdet's: ``conv1``, ``bn1``, ``layer{i}.{j}.conv1``,
``.bn1``, ``.convs.{k}``, ``.bns.{k}``, ``.conv3``, ``.bn3``,
``.downsample.{1,2}`` (``downsample.0`` is the pool). BN is
FrozenBatchNorm; ``frozen_stages`` freezes the stem and ``layer1..k``
(``layers.is_frozen``). ``dcn`` (with ``stage_with_dcn``) makes every
scale conv of those stages' blocks a deformable one (``ops/deform_conv.py``,
mmcv's ``convs.{k}.conv_offset`` names). ``style`` other than
``'pytorch'`` raises, as in the JAX package; so do an mmdet checkpoint's
deep stem (``stem.*``) and DCN offsets for a conv that is plain here,
each naming the key.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.backbones.regnet import refuse_dcn_offsets
from dsl_tpu_torch.models.backbones.resnest import avg_down
from dsl_tpu_torch.ops.deform_conv import dcn_pack
from dsl_tpu_torch.models.layers import (
    conv1x1, conv3x3, he_normal_, is_frozen, make_conv, make_norm,
    max_pool_3x3_s2)
from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.utils.torch_import import load_torch_backbone

ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 scales: int = 4, base_width: int = 26,
                 stage_type: str = "normal", norm_cfg: dict | None = None,
                 dcn: dict | None = None):
        super().__init__()
        width = int(planes * base_width / 64.0)
        out = planes * self.expansion
        self.stride = stride
        self.scales = scales
        self.stage_type = stage_type
        self.conv1 = conv1x1(inplanes, width * scales)
        self.bn1 = make_norm(norm_cfg, width * scales)
        self.convs = nn.ModuleList(
            conv3x3(width, width, stride) if dcn is None
            else dcn_pack(dcn, width, width, stride)
            for _ in range(scales - 1))
        self.bns = nn.ModuleList(make_norm(norm_cfg, width)
                                 for _ in range(scales - 1))
        self.conv3 = conv1x1(width * scales, out)
        self.bn3 = make_norm(norm_cfg, out)
        self.downsample = (avg_down(inplanes, out, stride, norm_cfg)
                           if stride != 1 or inplanes != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spx = torch.chunk(F.relu(self.bn1(self.conv1(x))), self.scales, dim=1)
        pieces, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            inp = (spx[i] if i == 0 or self.stage_type == "stage"
                   else sp + spx[i])
            sp = F.relu(bn(conv(inp)))
            pieces.append(sp)
        last = spx[-1]
        if self.stride != 1:
            last = F.avg_pool2d(last, 3, self.stride, 1)
        out = self.bn3(self.conv3(torch.cat(pieces + [last], dim=1)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


@BACKBONES.register(name="Res2Net")
class Res2Net(nn.Module):
    def __init__(self, depth: int = 50, scales: int = 4, base_width: int = 26,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 norm_cfg: dict | None = None, pretrained: str | None = None,
                 style: str = "pytorch", base_channels: int = 64,
                 dcn: dict | None = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4):
        super().__init__()
        # norm_eval is accepted for config parity: BN is FrozenBatchNorm
        if style != "pytorch":
            raise NotImplementedError(
                f"Res2Net: only style='pytorch' (the reference's res2net "
                f"configs all use it), got {style!r}")
        self.out_indices = tuple(out_indices)
        self.pretrained = pretrained
        self.conv1 = make_conv(None, 3, 64, 7, stride=2)
        self.bn1 = make_norm(norm_cfg, 64)
        inplanes = 64
        for i, n in enumerate(ARCH[depth]):
            planes = base_channels * 2 ** i
            blocks = []
            for j in range(n):
                blocks.append(Bottle2neck(
                    inplanes, planes, strides[i] if j == 0 else 1, scales,
                    base_width, "stage" if j == 0 else "normal", norm_cfg,
                    dcn if dcn is not None and stage_with_dcn[i] else None))
                inplanes = planes * Bottle2neck.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        for name, p in self.named_parameters():
            if is_frozen(name, frozen_stages):
                p.requires_grad_(False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        stem = sorted(k for k in state_dict if k.startswith(prefix + "stem."))
        if stem:
            raise KeyError(f"{stem[:4]}: mmdet's deep stem; the JAX package's "
                           f"Res2Net (and the port's) has a 7x7 conv1")
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
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
