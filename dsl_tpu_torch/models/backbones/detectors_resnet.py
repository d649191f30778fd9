"""DetectoRS's backbone: a ResNet whose 3x3 convs switch between two
dilations (SAC) and whose stages take the RFP neck's features, NCHW.

Counterpart of ``dsl_tpu/models/backbones/detectors_resnet.py``:

- ``SAConv``: plain convolutions as the JAX package writes them (no weight
  standardisation, mmcv's ``ConvAWS2d``, and no deformable branch): a 1x1
  ``pre_context`` on the input's spatial mean added to the input; a
  ``switch``, the sigmoid of a 1x1 conv (bias 1) on the input's 5x5 average
  pool (stride 1, padding 2, the padded zeros counted), taken at every
  ``stride``-th row and column; the output ``switch * conv(x, w, d=1) +
  (1 - switch) * conv(x, w + weight_diff, d=3)`` (padding 1 and 3, both at
  ``stride``); then a 1x1 ``post_context`` on the output's spatial mean
  added. The means are ``mean(dim=(2, 3))``: the CUDA backward of
  ``AdaptiveAvgPool2d`` adds with atomics. mmdet's names (``conv2.weight``,
  ``weight_diff``, ``switch``, ``pre_context``, ``post_context``); an mmdet
  checkpoint whose SAC holds ConvAWS buffers (``weight_gamma``,
  ``weight_beta``) or deformable offsets computes another function, and
  loading one raises naming those keys;
- ``RFPBottleneck``: pytorch style (the stride on the 3x3), FrozenBatchNorm,
  a strided 1x1 + BN shortcut where the shape changes; the first block of
  stages 2-4 has ``rfp_conv``, a 1x1 of ``rfp_inplanes`` channels (zero at
  init) whose output on the RFP feature is added before the last relu;
- ``DetectoRSResNet`` (depth 50 or 101; the JAX package's widths are
  fixed) and ``DetectoRSResNeXt`` (grouped, widened 3x3s, the SACs
  included): ``forward(images)``, and ``rfp_forward(images, rfp_feats)``,
  the same pass with ``rfp_feats[s - 1]`` fed to stage ``s`` (s = 1..3).
  The names are mmdet's ``DetectoRS_ResNet``'s (``conv1``, ``bn1``,
  ``layerS.B``), the JAX package's ``stem_conv``, ``stem_bn`` and
  ``stages_{S-1}_{B}`` crossing through the weight bridge. The JAX package
  has no ``frozen_stages`` here, so nothing of it is frozen, and no
  ``pretrained`` file (``pretrained=None``, which ``init_detector`` passes,
  is taken; a file raises).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_, make_norm, max_pool_3x3_s2
from dsl_tpu_torch.registry import BACKBONES

ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
# an mmdet SAConv2d's tensors that the JAX package's SAC does not compute
MMCV_SAC_ONLY = ("weight_gamma", "weight_beta", "offset_s", "offset_l")


class SAConv(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels, in_channels // groups,
                                               3, 3))
        self.weight_diff = nn.Parameter(torch.zeros_like(self.weight))
        self.pre_context = nn.Conv2d(in_channels, in_channels, 1)
        self.switch = nn.Conv2d(in_channels, 1, 1)
        self.post_context = nn.Conv2d(channels, channels, 1)

    def init_weights(self, generator: torch.Generator | None = None):
        he_normal_(self.weight, generator)
        nn.init.zeros_(self.weight_diff)
        for conv in (self.pre_context, self.post_context, self.switch):
            nn.init.normal_(conv.weight, 0.0, conv.weight[0].numel() ** -0.5,
                            generator=generator)
            nn.init.zeros_(conv.bias)
        nn.init.ones_(self.switch.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        other = sorted(k for k in state_dict if k.startswith(prefix) and
                       k[len(prefix):].split(".")[0] in MMCV_SAC_ONLY)
        if other:
            raise KeyError(
                f"{other[:4]}: an mmcv SAConv2d's weight standardisation or "
                f"deformable offsets; the JAX package's SAC (and the port's) "
                f"is plain convolutions and does not compute that function")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        x = x + self.pre_context(x.mean(dim=(2, 3), keepdim=True))
        avg = F.avg_pool2d(x, 5, stride=1, padding=2, count_include_pad=True)
        switch = torch.sigmoid(self.switch(avg))
        if s > 1:
            switch = switch[:, :, ::s, ::s]
        out1 = F.conv2d(x, self.weight, None, s, 1, 1, self.groups)
        out2 = F.conv2d(x, self.weight + self.weight_diff, None, s, 3, 3,
                        self.groups)
        out = switch * out1 + (1 - switch) * out2
        return out + self.post_context(out.mean(dim=(2, 3), keepdim=True))


class RFPBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 with_sac: bool = False, rfp_inplanes: int | None = None,
                 norm_cfg: dict | None = None, groups: int = 1,
                 base_width: int = 64):
        super().__init__()
        out = planes * self.expansion
        width = planes if groups == 1 else int(
            planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = make_norm(norm_cfg, width)
        self.conv2 = (SAConv(width, width, stride, groups) if with_sac
                      else nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                                     bias=False))
        self.bn2 = make_norm(norm_cfg, width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = make_norm(norm_cfg, out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False),
            make_norm(norm_cfg, out)) if stride != 1 or inplanes != out
            else None)
        self.rfp_conv = (nn.Conv2d(rfp_inplanes, out, 1)
                         if rfp_inplanes is not None else None)

    def forward(self, x: torch.Tensor,
                rfp_feat: torch.Tensor | None = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        out = y + identity
        if self.rfp_conv is not None and rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


@BACKBONES.register
class DetectoRSResNet(nn.Module):
    def __init__(self, depth: int = 50,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 sac_stages: Sequence[int] = (1, 2, 3),
                 stem_channels: int = 64, rfp_inplanes: int | None = 256,
                 norm_cfg: dict | None = None, groups: int = 1,
                 base_width: int = 64, pretrained: str | None = None):
        super().__init__()
        if pretrained:
            raise NotImplementedError(
                f"{type(self).__name__}(pretrained={pretrained!r}): the JAX "
                f"package's DetectoRS backbone reads no pretrained file")
        if depth not in ARCH:
            raise KeyError(f"invalid depth {depth} for {type(self).__name__}: "
                           f"{sorted(ARCH)}")
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, stem_channels, 7, 2, 3, bias=False)
        self.bn1 = make_norm(norm_cfg, stem_channels)
        inplanes, planes = stem_channels, 64
        self.stage_names = []
        for stage, n in enumerate(ARCH[depth]):
            blocks = []
            for blk in range(n):
                blocks.append(RFPBottleneck(
                    inplanes, planes, 2 if (stage > 0 and blk == 0) else 1,
                    with_sac=stage in tuple(sac_stages),
                    rfp_inplanes=(rfp_inplanes if blk == 0 and stage > 0
                                  else None),
                    norm_cfg=norm_cfg, groups=groups, base_width=base_width))
                inplanes = planes * RFPBottleneck.expansion
            name = f"layer{stage + 1}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            planes *= 2

    def init_weights(self, generator: torch.Generator | None = None):
        """He-normal convs, the SACs' own init, zero ``rfp_conv``s (the JAX
        package's)."""
        for m in self.modules():
            if isinstance(m, SAConv):
                m.init_weights(generator)
            elif isinstance(m, RFPBottleneck):
                for conv in (m.conv1, m.conv2, m.conv3, m.downsample):
                    if isinstance(conv, nn.Conv2d):
                        he_normal_(conv.weight, generator)
                    elif isinstance(conv, nn.Sequential):
                        he_normal_(conv[0].weight, generator)
                if m.rfp_conv is not None:
                    nn.init.zeros_(m.rfp_conv.weight)
                    nn.init.zeros_(m.rfp_conv.bias)
        he_normal_(self.conv1.weight, generator)

    def _run(self, images: torch.Tensor, rfp_feats=None):
        x = max_pool_3x3_s2(F.relu(self.bn1(self.conv1(images))))
        outs = []
        for stage, name in enumerate(self.stage_names):
            rfp = (None if rfp_feats is None or stage == 0
                   else rfp_feats[stage - 1])
            for blk, block in enumerate(getattr(self, name)):
                x = block(x, rfp if blk == 0 else None)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)

    def forward(self, images: torch.Tensor):
        return self._run(images)

    def rfp_forward(self, images: torch.Tensor, rfp_feats):
        return self._run(images, rfp_feats)


@BACKBONES.register
class DetectoRSResNeXt(DetectoRSResNet):
    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
