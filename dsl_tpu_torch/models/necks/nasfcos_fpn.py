"""NAS-FCOS's FPN and FPG, NCHW.

Counterpart of ``dsl_tpu/models/necks/nasfcos_fpn.py``.

``NASFCOS_FPN``: each backbone level from ``start_level`` adapted by a
1x1 conv (no bias), a FrozenBatchNorm and a relu (``in_channels`` are
the widths of every level the backbone gives, ``start_level`` picking
from them: the JAX module infers them from the levels, so the repo's
config, which names C3-C5 over a backbone giving C2-C5, adapts all four
there and here, ``build_neck``); the searched DAG of
concat cells (``c22_1, c22_2, c32, c02, c42, c36, c61``: cell ``cij`` reads
nodes ``i`` and ``j``, each appended as a new node), a cell resizing both
inputs to the larger's size, concatenating them and applying a
FrozenBatchNorm, a relu and a 1x1 conv (no bias); the outputs are nodes
9, 8, 7 plus node 5 resized to them, resized back to the input levels'
sizes; the extra levels stride-2 3x3 convs of the last, a relu before all
but the first.

``FPG`` (feature pyramid grids), in the JAX package's "sum and 3x3" form:
1x1 laterals, stride-2 3x3 extra levels, then ``stack_times`` stages in
which each level adds a stride-2 3x3 conv of the level below and a 1x1
conv of the level above resized to it, then a relu, a 3x3 conv and a
FrozenBatchNorm.

The resize is this module's own (the JAX package keeps one per module):
a larger map max-pooled at window and stride ``max(H // h, 1)`` and
cropped, a smaller one repeated ``h // H`` and ``w // W`` times
(``nas_fpn.repeat_nearest``: ``expand`` and ``reshape``) and cropped. Where
that does not give the level's size (FPG at 800x1344: P6 at 13 rows
repeated once for P5's 25) the sum raises, naming the neck and the two
sizes, as the JAX package's add does.

The parameters carry the JAX package's names (``adapt{i}``,
``adapt_bn{i}``, ``cell_{name}.out_bn`` / ``.out_conv``, ``extra{i}``;
FPG's ``lateral{i}``, ``extra{i}``, ``s{stage}_{bu,td,out,bn}{level}``): the
mmdet modules are built otherwise, so an mmdet checkpoint does not load.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    FrozenBatchNorm, he_normal_, refuse_foreign_keys)
from dsl_tpu_torch.models.necks.nas_fpn import check_sum, repeat_nearest
from dsl_tpu_torch.registry import NECKS

WIRING = ("c22_1", "c22_2", "c32", "c02", "c42", "c36", "c61")


def _resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    if tuple(x.shape[2:]) == (h, w):
        return x
    if x.shape[2] > h:
        k = max(x.shape[2] // h, 1)
        return F.max_pool2d(x, k, stride=k)[:, :, :h, :w]
    return repeat_nearest(x, h // x.shape[2], w // x.shape[3])[:, :, :h, :w]


def _init_convs(module: nn.Module, generator):
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            he_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


class ConcatCell(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.out_bn = FrozenBatchNorm(2 * channels)
        self.out_conv = nn.Conv2d(2 * channels, channels, 1, bias=False)

    def forward(self, x1, x2):
        hw = max(x1.shape[2], x2.shape[2]), max(x1.shape[3], x2.shape[3])
        x1, x2 = _resize_to(x1, hw), _resize_to(x2, hw)
        if x1.shape[2:] != x2.shape[2:]:
            raise ValueError(f"NASFCOS_FPN: levels of {tuple(x1.shape[2:])} "
                             f"and {tuple(x2.shape[2:])} do not concatenate "
                             f"(the JAX package raises there too)")
        return self.out_conv(F.relu(self.out_bn(torch.cat([x1, x2], dim=1))))


@NECKS.register
class NASFCOS_FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0):
        super().__init__()
        used = list(in_channels)[start_level:]
        self.start_level, self.num_outs = start_level, num_outs
        for i, c in enumerate(used):
            self.add_module(f"adapt{i}", nn.Conv2d(c, out_channels, 1,
                                                   bias=False))
            self.add_module(f"adapt_bn{i}", FrozenBatchNorm(out_channels))
        for name in WIRING:
            self.add_module(f"cell_{name}", ConcatCell(out_channels))
        # three outputs (nodes 9, 8, 7), then the extra levels
        for i in range(num_outs - 3):
            self.add_module(f"extra{i}", nn.Conv2d(out_channels, out_channels,
                                                   3, stride=2, padding=1))

    def init_weights(self, generator: torch.Generator | None = None):
        _init_convs(self, generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        refuse_foreign_keys(self, state_dict, prefix,
                            "the JAX package's NASFCOS_FPN (mmdet's differs)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, inputs):
        inputs = list(inputs)[self.start_level:]
        feats = [F.relu(getattr(self, f"adapt_bn{i}")(
            getattr(self, f"adapt{i}")(f))) for i, f in enumerate(inputs)]
        for name in WIRING:
            feats.append(getattr(self, f"cell_{name}")(feats[int(name[1])],
                                                       feats[int(name[2])]))
        outs = []
        for idx, src in zip((9, 8, 7), (0, 1, 2)):
            up = _resize_to(feats[5], feats[idx].shape[2:])
            check_sum("NASFCOS_FPN", feats[idx], up)
            outs.append(_resize_to(feats[idx] + up, inputs[src].shape[2:]))
        x = outs[-1]
        for i in range(self.num_outs - len(outs)):
            x = getattr(self, f"extra{i}")(F.relu(x) if i > 0 else x)
            outs.append(x)
        return tuple(outs)


@NECKS.register
class FPG(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 9, start_level: int = 0):
        super().__init__()
        used = list(in_channels)[start_level:]
        self.start_level, self.stack_times = start_level, stack_times
        self.num_levels = max(num_outs, len(used))
        for i, c in enumerate(used):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        self.num_extra = num_outs - len(used)
        for i in range(self.num_extra):
            self.add_module(f"extra{i}", nn.Conv2d(out_channels, out_channels,
                                                   3, stride=2, padding=1))
        for s in range(stack_times):
            for lvl in range(self.num_levels):
                if lvl > 0:
                    self.add_module(f"s{s}_bu{lvl}", nn.Conv2d(
                        out_channels, out_channels, 3, stride=2, padding=1))
                if lvl < self.num_levels - 1:
                    self.add_module(f"s{s}_td{lvl}", nn.Conv2d(
                        out_channels, out_channels, 1))
                self.add_module(f"s{s}_out{lvl}", nn.Conv2d(
                    out_channels, out_channels, 3, padding=1))
                self.add_module(f"s{s}_bn{lvl}", FrozenBatchNorm(out_channels))

    def init_weights(self, generator: torch.Generator | None = None):
        _init_convs(self, generator)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        refuse_foreign_keys(self, state_dict, prefix,
                            "the JAX package's FPG (mmdet's differs)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, inputs):
        feats = list(inputs)[self.start_level:]
        levels = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.num_extra):
            levels.append(getattr(self, f"extra{i}")(levels[-1]))
        n = len(levels)
        for s in range(self.stack_times):
            new = []
            for lvl in range(n):
                acc = levels[lvl]
                if lvl > 0:
                    bu = getattr(self, f"s{s}_bu{lvl}")(levels[lvl - 1])
                    check_sum("FPG", acc, bu)
                    acc = acc + bu
                if lvl < n - 1:
                    td = getattr(self, f"s{s}_td{lvl}")(
                        _resize_to(levels[lvl + 1], acc.shape[2:]))
                    check_sum("FPG", acc, td)
                    acc = acc + td
                y = getattr(self, f"s{s}_out{lvl}")(F.relu(acc))
                new.append(getattr(self, f"s{s}_bn{lvl}")(y))
            levels = new
        return tuple(levels)
