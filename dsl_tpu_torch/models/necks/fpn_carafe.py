"""FPN with CARAFE upsampling, NCHW.

Counterpart of ``dsl_tpu/models/necks/fpn_carafe.py``: the FPN's top-down
path upsamples each level by content-aware reassembly
(``ops/misc_ops.py::carafe``) instead of nearest: a 1x1 channel compressor
(64 channels), a 3x3 content encoder predicting ``up_kernel**2 * 4``
kernel weights per source pixel, those shuffled to the 2x-upsampled grid
and softmax-normalised over the taps, then the reassembly, cropped to the
lateral below. Each level then goes through a 3x3 conv; the extra levels
are max pools of the last with kernel 1 and stride 2 (the JAX package's,
where mmdet's FPN_CARAFE adds convs).

Submodule names are mmdet's (``lateral_convs.i.conv``, ``fpn_convs.i.conv``,
``upsample_modules.{i-1}`` upsampling level ``i`` with mmcv
``CARAFEPack``'s ``channel_compressor`` and ``content_encoder``). The
content encoder's channels are mmcv's order, tap-major (``F.pixel_shuffle``
of ``k*k`` groups of ``scale**2``); the JAX package reshapes them
sub-pixel-major, ``(scale, scale, k*k)``, and the weight bridge permutes
them. An mmdet checkpoint's extra levels (``lateral_convs.{n}`` and
beyond, convs here absent) raise on load, naming the key.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.models.necks.fpn import _ConvModule
from dsl_tpu_torch.ops.misc_ops import carafe
from dsl_tpu_torch.registry import NECKS


class CARAFEUpsample(nn.Module):
    """mmcv ``CARAFEPack`` as the JAX package's ``CARAFEUpsample``
    computes it (one group, encoder dilation 1)."""

    def __init__(self, channels: int, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64,
                 scale: int = 2):
        super().__init__()
        self.up_kernel, self.scale = up_kernel, scale
        self.channel_compressor = nn.Conv2d(channels, compressed_channels, 1)
        self.content_encoder = nn.Conv2d(
            compressed_channels, up_kernel ** 2 * scale ** 2, encoder_kernel,
            padding=encoder_kernel // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        masks = self.content_encoder(self.channel_compressor(x))
        masks = torch.softmax(F.pixel_shuffle(masks, self.scale), dim=1)
        return carafe(x, masks, self.up_kernel, self.scale)


@NECKS.register
class FPN_CARAFE(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, up_kernel: int = 5):
        super().__init__()
        used = list(in_channels)[start_level:]
        self.start_level, self.num_outs = start_level, num_outs
        self.lateral_convs = nn.ModuleList(
            _ConvModule(nn.Conv2d(c, out_channels, 1)) for c in used)
        self.fpn_convs = nn.ModuleList(
            _ConvModule(nn.Conv2d(out_channels, out_channels, 3, padding=1))
            for _ in used)
        self.upsample_modules = nn.ModuleList(
            CARAFEUpsample(out_channels, up_kernel=up_kernel)
            for _ in range(len(used) - 1))

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        n = len(self.lateral_convs)
        for key in state_dict:
            rest = key[len(prefix):].split(".") if key.startswith(prefix) else []
            if (len(rest) > 1 and rest[0] in ("lateral_convs", "fpn_convs")
                    and int(rest[1]) >= n):
                raise KeyError(f"{key}: an extra level's conv, which the JAX "
                               f"package's FPN_CARAFE does not have (its "
                               f"extra levels are max pools)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, feats):
        laterals = [lat(x) for lat, x in zip(self.lateral_convs,
                                             feats[self.start_level:])]
        for i in range(len(laterals) - 1, 0, -1):
            up = self.upsample_modules[i - 1](laterals[i])
            h, w = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        x = outs[-1]
        for _ in range(self.num_outs - len(outs)):
            x = F.max_pool2d(x, 1, stride=2)
            outs.append(x)
        return tuple(outs)
