"""NAS-FPN, NCHW.

Counterpart of ``dsl_tpu/models/necks/nas_fpn.py``: 1x1 laterals on the
backbone levels from ``start_level`` (``in_channels`` are the widths of
every level the backbone gives, as the JAX module infers them from the
levels: ``channel_mapper.build_neck``), extra levels each a 1x1 conv of the
last then a 2x2 max pool (none once a level is 1x1), then ``stack_times``
repetitions of the searched cells over P3-P7: a sum cell adds its two
inputs, a global-pooling cell adds the second to the first gated by the
sigmoid of the second's mean; both inputs resized to the cell's level
first, then a relu, a 3x3 conv and a norm (FrozenBatchNorm; GroupNorm for
``norm_cfg=dict(type='GN')``), but in the two cells without an out conv.

The resize is this module's own, as the JAX package keeps one per module:
a larger map is max-pooled at window and stride ``H // h`` (floor mode, the
same window on both axes), a smaller one repeated ``h // H`` and ``w //
W`` times (``expand`` and ``reshape``, whose backward repeats on the card)
and cropped. Where that does not give the level's size (an odd P5: at
800x1344 P6 pools 25 rows to 12, and 12 repeated by ``50 // 12`` gives
back 48) the cell's sum raises, naming the neck and the two sizes, where
the JAX package raises on the add; at 640x640 every cell fits.

The parameters carry the JAX package's names (``lateral{i}``,
``extra{i}``, ``s{stack}_{cell}.out_conv``, ``.out_bn``): the mmdet module
differs (laterals and extras with a BN and no bias), so an mmdet
checkpoint does not load (its keys have no counterpart here).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import (
    he_normal_, make_norm, refuse_foreign_keys)
from dsl_tpu_torch.registry import NECKS

# (name, op, first input, second input, output level), P3-P7 as 0-4 and
# the cells' own outputs as the JAX package names them
CELLS = (("gp_64_4", "gp", "p6", "p4", "p4", "p4_1"),
         ("sum_44_4", "sum", "p4_1", "p4", "p4", "p4_2"),
         ("sum_43_3", "sum", "p4_2", "p3", "p3", "p3"),
         ("sum_34_4", "sum", "p3", "p4_2", "p4", "p4"),
         ("gp_43_5", "gp", "p4", "p3", "p5", "p5_tmp"),
         ("sum_55_5", "sum", "p5_tmp", "p5", "p5", "p5"),
         ("gp_54_7", "gp", "p5", "p4_2", "p7", "p7_tmp"),
         ("sum_77_7", "sum", "p7_tmp", "p7", "p7", "p7"),
         ("gp_75_6", "gp", "p7", "p5", "p6", "p6"))
NO_OUT_CONV = ("gp_43_5", "gp_54_7")


def repeat_nearest(x: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """``jnp.repeat`` of rows ``ry`` and columns ``rx`` times, as an
    ``expand`` and a ``reshape`` (no index gather)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, ry, w, rx).reshape(
        b, c, h * ry, w * rx)


def _resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    h, w = hw
    if tuple(x.shape[2:]) == (h, w):
        return x
    if x.shape[2] > h:
        k = x.shape[2] // h
        return F.max_pool2d(x, k, stride=k)
    return repeat_nearest(x, h // x.shape[2], w // x.shape[3])[:, :, :h, :w]


def check_sum(neck: str, a: torch.Tensor, b: torch.Tensor):
    """Raise, naming ``neck`` and both sizes, where ``a + b`` would not
    broadcast (the JAX package's add raises there)."""
    for x, y in zip(a.shape, b.shape):
        if x != y and 1 not in (x, y):
            raise ValueError(f"{neck}: levels of {tuple(a.shape[2:])} and "
                             f"{tuple(b.shape[2:])} do not add (the JAX "
                             f"package raises there too: its resize fits "
                             f"levels that halve evenly, as at 640x640, not "
                             f"an odd P5, as at 800x1344)")


class _Cell(nn.Module):
    def __init__(self, channels: int, op: str, with_out_conv: bool = True,
                 norm_cfg: dict | None = None):
        super().__init__()
        self.op = op
        self.out_conv = (nn.Conv2d(channels, channels, 3, padding=1)
                         if with_out_conv else None)
        self.out_bn = (make_norm(norm_cfg, channels) if with_out_conv
                       else None)

    def forward(self, x1, x2, out_hw):
        x1, x2 = _resize_to(x1, out_hw), _resize_to(x2, out_hw)
        if self.op == "gp":
            gated = torch.sigmoid(x2.mean(dim=(2, 3), keepdim=True)) * x1
            check_sum("NASFPN", x2, gated)
            y = x2 + gated
        else:
            check_sum("NASFPN", x1, x2)
            y = x1 + x2
        if self.out_conv is None:
            return y
        return self.out_bn(self.out_conv(F.relu(y)))


@NECKS.register
class NASFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 7, start_level: int = 0,
                 norm_cfg: dict | None = None):
        super().__init__()
        used = list(in_channels)[start_level:]
        if num_outs != 5:
            raise ValueError(f"NASFPN num_outs {num_outs}: the cells read "
                             f"P3-P7")
        self.start_level, self.stack_times = start_level, stack_times
        for i, c in enumerate(used):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        self.num_extra = num_outs - len(used)
        for i in range(self.num_extra):
            self.add_module(f"extra{i}", nn.Conv2d(out_channels, out_channels,
                                                   1))
        for s in range(stack_times):
            for name, op, *_ in CELLS:
                self.add_module(f"s{s}_{name}", _Cell(
                    out_channels, op, name not in NO_OUT_CONV, norm_cfg))
        self.num_laterals = len(used)

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        refuse_foreign_keys(self, state_dict, prefix,
                            "the JAX package's NASFPN (mmdet's differs)")
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, feats):
        feats = list(feats)[self.start_level:]
        outs = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(self.num_extra):
            y = getattr(self, f"extra{i}")(outs[-1])
            if y.shape[2] > 1 or y.shape[3] > 1:
                y = F.max_pool2d(y, 2, stride=2)
            outs.append(y)
        p = dict(zip(("p3", "p4", "p5", "p6", "p7"), outs))
        for s in range(self.stack_times):
            for name, _, a, b, level, out in CELLS:
                p[out] = getattr(self, f"s{s}_{name}")(
                    p[a], p[b], p[level].shape[2:])
        return tuple(p[k] for k in ("p3", "p4", "p5", "p6", "p7"))
