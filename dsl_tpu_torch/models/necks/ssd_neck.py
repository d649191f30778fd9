"""SSD neck: extra down-sampling levels after a backbone's outputs, NCHW.

Counterpart of ``dsl_tpu/models/necks/ssd_neck.py::SSDNeck``: the input
levels pass unchanged (the first through an ``L2Norm`` of init scale
``l2_norm_scale`` where one is set); each extra level is a 1x1 conv to
half its width and a 3x3 (the last ``last_kernel_size``) conv at
``level_strides[i]``, each followed by a norm where ``norm_cfg`` is set
(no bias then) and a relu; with ``use_depthwise`` (SSDLite) the second is
a depthwise conv, a norm (BN where no ``norm_cfg``) and relu, then a
pointwise conv. Module names are the JAX package's (``extra0_conv1``,
``extra0_bn1``, ``extra0_dw``, ``l2_norm``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import NECKS
from dsl_tpu_torch.models.backbones.ssd_vgg import L2Norm, lecun_normal_
from dsl_tpu_torch.models.layers import make_norm


@NECKS.register
class SSDNeck(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (96, 1280),
                 out_channels: Sequence[int] = (96, 1280, 512, 256, 256, 128),
                 level_strides: Sequence[int] = (2, 2, 2, 2),
                 level_paddings: Sequence[int] = (1, 1, 1, 1),
                 l2_norm_scale: float | None = None,
                 last_kernel_size: int = 3, use_depthwise: bool = False,
                 norm_cfg: dict | None = None):
        super().__init__()
        if len(out_channels) <= len(in_channels):
            raise ValueError("SSDNeck needs more out_channels than "
                             "in_channels")
        self.l2_norm = (L2Norm(in_channels[0], l2_norm_scale)
                        if l2_norm_scale else None)
        bias = norm_cfg is None
        extra = list(out_channels)[len(in_channels):]
        cin = in_channels[-1]
        # per level, groups of module names, each group followed by a relu
        self.levels = []
        for i, (oc, stride, pad) in enumerate(
                zip(extra, level_strides, level_paddings)):
            k = last_kernel_size if i == len(extra) - 1 else 3
            mid = oc // 2

            def group(conv_name, conv, norm_name, width, norm=norm_cfg):
                self.add_module(conv_name, conv)
                if norm is None:
                    return [conv_name]
                self.add_module(norm_name, make_norm(norm, width))
                return [conv_name, norm_name]

            groups = [group(f"extra{i}_conv1", nn.Conv2d(cin, mid, 1, bias=bias),
                            f"extra{i}_bn1", mid)]
            if use_depthwise:
                groups.append(group(
                    f"extra{i}_dw", nn.Conv2d(mid, mid, k, stride, pad,
                                              groups=mid, bias=False),
                    f"extra{i}_dwbn", mid, norm_cfg or dict(type="BN")))
                groups.append(group(f"extra{i}_pw",
                                    nn.Conv2d(mid, oc, 1, bias=bias),
                                    f"extra{i}_pwbn", oc))
            else:
                groups.append(group(f"extra{i}_conv2",
                                    nn.Conv2d(mid, oc, k, stride, pad,
                                              bias=bias),
                                    f"extra{i}_bn2", oc))
            self.levels.append(groups)
            cin = oc

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, feats):
        feats = list(feats)
        if self.l2_norm is not None:
            feats[0] = self.l2_norm(feats[0])
        x = feats[-1]
        for groups in self.levels:
            for names in groups:
                for name in names:
                    x = getattr(self, name)(x)
                x = F.relu(x)
            feats.append(x)
        return tuple(feats)
