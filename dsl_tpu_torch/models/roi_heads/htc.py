"""HTC's heads: the fused semantic head and the info-flow mask head.

Counterpart of ``dsl_tpu/models/roi_heads/htc.py``, NCHW:

- ``resize_bilinear`` and ``jax_resize_weights`` (``jax.image.resize``'s
  bilinear as two matrix products) live in ``ops/resize.py`` and are
  imported here, where HTC's tests read them;
- ``FusedSemanticHead``: a 1x1 lateral with relu per level, the levels
  resized onto ``fusion_level``'s size and summed, ``num_convs`` 3x3 convs
  with relu, then ``conv_logits`` (a logit per class) and ``conv_embedding``
  (with relu), mmdet's names (``lateral_convs.i.conv``, ``convs.i.conv``,
  ``conv_embedding.conv``, ``conv_logits``); returns (logits, embedding);
- ``HTCMaskHead``: ``FCNMaskHead`` that first adds the previous stage's
  conv features through a 1x1 ``conv_res`` with relu (``with_conv_res``)
  and returns its own conv features beside the logits;
- ``semantic_seg_loss``: softmax cross-entropy per pixel, 255 and labels
  at or past the class count ignored, the mean over the valid pixels,
  times ``loss_weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.models.layers import he_normal_
from dsl_tpu_torch.models.roi_heads.mask_head import FCNMaskHead
from dsl_tpu_torch.ops.resize import (  # noqa: F401 (HTC's tests read them)
    jax_resize_weights, resize_bilinear)
from dsl_tpu_torch.registry import HEADS


class _ConvModule(nn.Module):
    """mmcv ``ConvModule`` of a conv with bias and relu (``.conv``)."""

    def __init__(self, in_channels: int, out_channels: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, k, padding=k // 2)

    def forward(self, x):
        return F.relu(self.conv(x))


@HEADS.register
class FusedSemanticHead(nn.Module):
    def __init__(self, num_ins: int = 5, fusion_level: int = 1,
                 num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 183,
                 loss_weight: float = 0.2):
        super().__init__()
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.loss_weight = loss_weight
        self.lateral_convs = nn.ModuleList(
            _ConvModule(in_channels, in_channels, 1) for _ in range(num_ins))
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList(_ConvModule(chans[i], chans[i + 1], 3)
                                   for i in range(num_convs))
        self.conv_embedding = _ConvModule(chans[-1], conv_out_channels, 1)
        self.conv_logits = nn.Conv2d(chans[-1], num_classes, 1)

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)

    def forward(self, feats):
        """FPN levels (NCHW) -> (logits (B, classes, h, w), embedding (B,
        conv_out, h, w)) at ``fusion_level``'s size."""
        laterals = [lat(f) for lat, f in
                    zip(self.lateral_convs, feats[:self.num_ins])]
        x = laterals[self.fusion_level]
        hw = x.shape[-2:]
        for i, lat in enumerate(laterals):
            if i != self.fusion_level:
                x = x + resize_bilinear(lat, hw)
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(x), self.conv_embedding(x)


@HEADS.register
class HTCMaskHead(FCNMaskHead):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 conv_out_channels: int = 256, num_convs: int = 4,
                 roi_size: int = 14, with_conv_res: bool = True):
        super().__init__(num_classes, in_channels, conv_out_channels,
                         num_convs, roi_size)
        self.conv_out_channels = conv_out_channels
        self.conv_res = (_ConvModule(conv_out_channels, conv_out_channels, 1)
                         if with_conv_res else None)

    def init_weights(self, generator: torch.Generator | None = None):
        super().init_weights(generator)
        if self.conv_res is not None:
            he_normal_(self.conv_res.conv.weight, generator)
            nn.init.zeros_(self.conv_res.conv.bias)

    def forward(self, roi_feats: torch.Tensor,
                res_feat: torch.Tensor | None = None):
        """roi_feats (N, C, s, s) and the previous head's features, where
        given -> (logits (N, classes, 2s, 2s), features (N, C', s, s))."""
        x = roi_feats
        if res_feat is not None and self.conv_res is not None:
            x = x + self.conv_res(res_feat)
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x))), x


def semantic_seg_loss(seg_logits: torch.Tensor, target: torch.Tensor,
                      loss_weight: float = 0.2,
                      ignore_label: int = 255) -> torch.Tensor:
    """Cross-entropy of logits (B, C, h, w) against labels (B, h, w),
    averaged over the pixels whose label is neither ``ignore_label`` nor
    past the classes."""
    nc = seg_logits.shape[1]
    target = target.to(torch.int64)
    valid = (target != ignore_label) & (target < nc)
    logp = torch.log_softmax(seg_logits, dim=1)
    ce = -torch.gather(logp, 1, target.clamp(0, nc - 1)[:, None])[:, 0]
    ce = torch.where(valid, ce, ce.new_zeros(()))
    return loss_weight * ce.sum() / torch.clamp_min(
        valid.to(torch.float32).sum(), 1.0)
