"""HRNet backbone, NCHW.

Counterpart of ``dsl_tpu/models/backbones/hrnet.py`` (mmdet's ``HRNet``):
a stem of two stride-2 3x3 convs, a stage of ``Bottleneck`` blocks, then
stages of parallel ``BasicBlock`` branches at halving resolutions, each
``HRModule`` ending in a full fuse: branch ``j`` reaches branch ``i > j``
through a chain of stride-2 3x3 convs (a relu between them) and branch
``i < j`` through a 1x1 conv, a norm and the nearest resize to branch
``i``'s size (``ops/resize.py::resize_nearest``: ``jax.image.resize``'s
rule, ``floor((i + 0.5) * in / out)``, which differs from mmdet's
``scale_factor`` upsample wherever a branch was halved from an odd size;
its backward is a matrix product, so a step repeats on the card). A
transition adapts a branch whose width changes (3x3, stride 1) and makes
each new branch from the last one (3x3, stride 2). The ``extra`` dict
configures the stages as in mmdet (``DEFAULT_EXTRA`` is W18); every
branch of the last stage comes out (W18: 18, 36, 72, 144 channels at
strides 4, 8, 16, 32).

Submodule names are mmdet's: ``conv1``, ``bn1``, ``conv2``, ``bn2``,
``layer1.{k}``, ``transition{s}.{b}`` (``.0`` / ``.1`` where a branch is
adapted, ``.0.0`` / ``.0.1`` where it is new), ``stage{s}.{m}.branches.{b}.{k}``
and ``stage{s}.{m}.fuse_layers.{i}.{j}`` (``.0`` / ``.1`` up, ``.{k}.0`` /
``.{k}.1`` down). BN is FrozenBatchNorm. ``frozen_stages`` freezes what
the JAX package's optimizer mask does (``layers.is_frozen``): ``conv1``,
``bn1`` and ``layer1``, not ``conv2`` / ``bn2``.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.backbones.resnet import BasicBlock, Bottleneck
from dsl_tpu_torch.models.layers import (
    conv1x1, conv3x3, he_normal_, is_frozen, make_norm)
from dsl_tpu_torch.ops.resize import resize_nearest
from dsl_tpu_torch.registry import BACKBONES
from dsl_tpu_torch.utils.torch_import import load_torch_backbone

DEFAULT_EXTRA = dict(
    stage1=dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                num_blocks=(4,), num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, block="BASIC",
                num_blocks=(4, 4), num_channels=(18, 36)),
    stage3=dict(num_modules=4, num_branches=3, block="BASIC",
                num_blocks=(4, 4, 4), num_channels=(18, 36, 72)),
    stage4=dict(num_modules=3, num_branches=4, block="BASIC",
                num_blocks=(4, 4, 4, 4), num_channels=(18, 36, 72, 144)),
)


def _conv_bn(cin: int, cout: int, stride: int, norm_cfg, relu: bool,
             kernel: int = 3) -> nn.Sequential:
    conv = (conv3x3(cin, cout, stride) if kernel == 3
            else conv1x1(cin, cout, stride))
    layers = [conv, make_norm(norm_cfg, cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class HRModule(nn.Module):
    """``num_branches`` chains of ``BasicBlock``s, then the full fuse
    (every output the relu of the sum over the branches, in branch
    order)."""

    def __init__(self, num_branches: int, num_blocks, channels,
                 norm_cfg: dict | None = None):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(channels[b], channels[b],
                                       norm_cfg=norm_cfg,
                                       zero_init_residual=False)
                            for _ in range(num_blocks[b])))
            for b in range(num_branches))
        self.fuse_layers = None
        if num_branches > 1:
            self.fuse_layers = nn.ModuleList()
            for i in range(num_branches):
                row = nn.ModuleList()
                for j in range(num_branches):
                    if j > i:
                        row.append(_conv_bn(channels[j], channels[i], 1,
                                            norm_cfg, False, kernel=1))
                    elif j < i:
                        row.append(nn.Sequential(*(
                            _conv_bn(channels[j],
                                     channels[i] if k == i - j - 1
                                     else channels[j], 2, norm_cfg,
                                     k != i - j - 1)
                            for k in range(i - j))))
                    else:
                        row.append(None)
                self.fuse_layers.append(row)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j]
                if j > i:
                    y = resize_nearest(layer(y), outs[i].shape[2:])
                elif j < i:
                    y = layer(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


@BACKBONES.register(name="HRNet")
class HRNet(nn.Module):
    def __init__(self, extra: dict | None = None,
                 norm_cfg: dict | None = None, frozen_stages: int = -1,
                 norm_eval: bool = True, pretrained: str | None = None):
        super().__init__()
        # norm_eval is accepted for config parity: BN is FrozenBatchNorm
        extra = copy.deepcopy(extra or DEFAULT_EXTRA)
        self.pretrained = pretrained
        self.conv1 = conv3x3(3, 64, 2)
        self.bn1 = make_norm(norm_cfg, 64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = make_norm(norm_cfg, 64)
        s1 = extra["stage1"]
        planes = s1["num_channels"][0]
        blocks, inplanes = [], 64
        for _ in range(s1["num_blocks"][0]):
            blocks.append(Bottleneck(inplanes, planes, norm_cfg=norm_cfg,
                                     zero_init_residual=False))
            inplanes = planes * Bottleneck.expansion
        self.layer1 = nn.Sequential(*blocks)
        prev = [inplanes]
        self.stage_keys = ("stage2", "stage3", "stage4")
        for s, key in enumerate(self.stage_keys, start=1):
            cfg = extra[key]
            chans = list(cfg["num_channels"])
            trans = nn.ModuleList()
            for b in range(cfg["num_branches"]):
                if b < len(prev):
                    trans.append(None if prev[b] == chans[b] else
                                 _conv_bn(prev[b], chans[b], 1, norm_cfg, True))
                else:
                    trans.append(nn.Sequential(
                        _conv_bn(prev[-1], chans[b], 2, norm_cfg, True)))
            self.add_module(f"transition{s}", trans)
            self.add_module(key, nn.Sequential(*(
                HRModule(cfg["num_branches"], cfg["num_blocks"], chans,
                         norm_cfg) for _ in range(cfg["num_modules"]))))
            prev = chans
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
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for s, key in enumerate(self.stage_keys, start=1):
            trans = getattr(self, f"transition{s}")
            # a new branch (past the last) comes from the last one
            xs = [xs[b] if t is None else t(xs[min(b, len(xs) - 1)])
                  for b, t in enumerate(trans)]
            xs = getattr(self, key)(xs)
        return tuple(xs)
