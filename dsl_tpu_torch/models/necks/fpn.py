"""Feature Pyramid Network, NCHW.

Counterpart of ``dsl_tpu/models/necks/fpn.py``: the levels from
``start_level`` to the last come from lateral + top-down fusion (the
top-down upsample nearest 2x, cropped to the lateral's size, or with
``upsample_cfg=dict(mode='bilinear')``, YOLACT's, ``jax.image.resize``'s
bilinear to the lateral's exact size, ``ops/resize.py``), then
``num_outs`` minus those extra levels:

- ``add_extra_convs=False`` (Faster R-CNN): each a max-pool of the level
  before with kernel 1 and stride 2 (the input's even rows and columns);
- ``'on_input'`` (or ``True``; RetinaNet): stride-2 3x3 convs, the first
  reading the last backbone level used;
- ``'on_output'`` (FCOS): the same, the first reading the last output;

with a relu before every extra conv but the first where
``relu_before_extra_convs``. ``conv_cfg=dict(type='ConvWS')`` makes every
conv weight-standardised, and ``norm_cfg=dict(type='GN')`` puts a
GroupNorm after each output and extra conv (and after the laterals where
``no_norm_on_lateral`` is False), those convs then without a bias, as in
the JAX package (the gn+ws configs). ``'on_lateral'``, another norm type
and another ``end_level`` raise.

Submodule names are mmdet's: ``lateral_convs.i.conv`` and ``fpn_convs.i.conv``
(``.gn`` beside them), the extra convs continuing the ``fpn_convs``
numbering.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import NECKS
from dsl_tpu_torch.models.layers import make_conv, make_norm
from dsl_tpu_torch.ops.resize import resize_bilinear


def _upsample_nearest_2x(x: torch.Tensor, target_hw) -> torch.Tensor:
    """Repeat 2x then crop to the lateral's (H, W) — the JAX package's form,
    which differs from ``interpolate(size=...)`` on odd sizes."""
    th, tw = target_hw
    out = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return out[:, :, :th, :tw]


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` with no activation and an optional GroupNorm:
    keeps the ``.conv`` / ``.gn`` level of mmdet's parameter names."""

    def __init__(self, conv: nn.Conv2d, gn: nn.Module | None = None):
        super().__init__()
        self.conv = conv
        self.gn = gn

    def forward(self, x):
        x = self.conv(x)
        return x if self.gn is None else self.gn(x)


@NECKS.register
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, end_level: int = -1,
                 add_extra_convs: bool | str = False,
                 relu_before_extra_convs: bool = False,
                 no_norm_on_lateral: bool = True, conv_cfg: dict | None = None,
                 norm_cfg: dict | None = None,
                 upsample_cfg: dict | None = None):
        super().__init__()
        if add_extra_convs is True:
            add_extra_convs = "on_input"
        if add_extra_convs not in (False, "on_input", "on_output") \
                or end_level != -1:
            raise NotImplementedError(
                f"FPN add_extra_convs={add_extra_convs!r}, end_level="
                f"{end_level}: only False, 'on_input' and 'on_output' to the "
                f"last level are ported")
        if norm_cfg is not None and norm_cfg.get("type") != "GN":
            raise NotImplementedError(f"FPN norm {norm_cfg.get('type')} is "
                                      f"not ported yet: only GN")
        self.upsample_mode = (upsample_cfg or {}).get("mode", "nearest")
        if self.upsample_mode not in ("nearest", "bilinear"):
            raise NotImplementedError(f"FPN upsample mode "
                                      f"{self.upsample_mode!r}: only nearest "
                                      f"and bilinear are ported")
        self.in_channels = list(in_channels)
        self.start_level = start_level
        self.relu_before_extra_convs = relu_before_extra_convs
        self.add_extra_convs = add_extra_convs
        self.num_outs = num_outs
        used = self.in_channels[start_level:]

        def conv(cin, k, stride, norm=True):
            norm = norm and norm_cfg is not None
            return _ConvModule(
                make_conv(conv_cfg, cin, out_channels, k, stride,
                          use_bias=norm_cfg is None),
                make_norm(norm_cfg, out_channels) if norm else None)

        self.lateral_convs = nn.ModuleList(
            conv(c, 1, 1, norm=not no_norm_on_lateral) for c in used)
        convs = [conv(out_channels, 3, 1) for _ in used]
        if add_extra_convs:
            first = used[-1] if add_extra_convs == "on_input" else out_channels
            convs += [conv(first if i == 0 else out_channels, 3, 2)
                      for i in range(num_outs - len(used))]
        self.fpn_convs = nn.ModuleList(convs)

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, inputs):
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"FPN got {len(inputs)} inputs for "
                             f"{len(self.in_channels)} in_channels")
        used = inputs[self.start_level:]
        n_used = len(used)
        laterals = [lat(x) for lat, x in zip(self.lateral_convs, used)]
        up = (resize_bilinear if self.upsample_mode == "bilinear"
              else _upsample_nearest_2x)
        for i in range(n_used - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + up(laterals[i],
                                                   laterals[i - 1].shape[2:])
        outs = [self.fpn_convs[i](laterals[i]) for i in range(n_used)]
        if not self.add_extra_convs:
            while len(outs) < self.num_outs:
                outs.append(F.max_pool2d(outs[-1], 1, stride=2))
            return tuple(outs)
        src = used[-1] if self.add_extra_convs == "on_input" else outs[-1]
        for i, extra in enumerate(self.fpn_convs[n_used:]):
            if i > 0 and self.relu_before_extra_convs:
                src = F.relu(src)
            src = extra(src)
            outs.append(src)
        return tuple(outs)
