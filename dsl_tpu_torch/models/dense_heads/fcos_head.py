"""FCOS head (inference) and its batched decode + multiclass NMS.

Counterpart of ``dsl_tpu/models/dense_heads/fcos_head.py``: ``FCOSHead``
(4-conv GN(32) cls/reg towers shared over levels, 3x3 predictors, a
learnable Scale per level on the box branch, centerness on the reg tower,
``norm_on_bbox``) and ``fcos_get_bboxes``. The towers run NCHW; the head
returns NHWC per level, the JAX package's layout, so that decode flattens
``(y, x, c)`` exactly as it does there. The DSL loss (``fcos_loss``) is not
ported yet.

Submodule names are mmdet's: ``cls_convs.i.{conv,gn}``, ``reg_convs.i``,
``conv_cls``, ``conv_reg``, ``conv_centerness``, ``scales.i``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import HEADS
from dsl_tpu_torch.core.boxes import distance2bbox
from dsl_tpu_torch.core.nms import multiclass_nms
from dsl_tpu_torch.core.points import MlvlPointGenerator
from dsl_tpu_torch.models.layers import (
    GroupNorm, Scale, bias_init_with_prob, normal_init)


class _TowerConv(nn.Module):
    """conv -> GN -> relu, with mmcv ``ConvModule``'s ``conv``/``gn`` names."""

    def __init__(self, cin: int, cout: int, use_bias: bool):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=use_bias)
        self.gn = GroupNorm(cout, 32)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


@HEADS.register
class FCOSHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 norm_on_bbox: bool = True, centerness_on_reg: bool = True,
                 dcn_on_last_conv: bool = False,
                 conv_bias: bool | str = True, norm_cfg: dict | None = None,
                 **train_only):
        """``train_only`` takes the loss and target options of the config
        (regress_ranges, center_sampling, loss_weight, soft_weight, loss_*,
        ...), which the predict path does not read."""
        super().__init__()
        if dcn_on_last_conv:
            raise NotImplementedError("FCOSHead dcn_on_last_conv is not ported yet")
        self.num_classes = num_classes
        self.strides = list(strides)
        self.norm_on_bbox = norm_on_bbox
        self.centerness_on_reg = centerness_on_reg
        use_bias = (conv_bias if isinstance(conv_bias, bool)
                    else norm_cfg is None)
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            _TowerConv(chans[i], chans[i + 1], use_bias)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            _TowerConv(chans[i], chans[i + 1], use_bias)
            for i in range(stacked_convs))
        self.conv_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.conv_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in self.strides)

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_init(m, 0.01, generator=generator)
        normal_init(self.conv_cls, 0.01, bias_init_with_prob(0.01), generator)

    def forward(self, feats):
        """feats: NCHW FPN levels. Returns (cls_scores, bbox_preds,
        centernesses), each a tuple of NHWC tensors with C = num_classes /
        4 / 1; bbox_preds are in image pixels (inference mode)."""
        cls_scores, bbox_preds, centernesses = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            cls_score = self.conv_cls(cls_feat)
            bbox_pred = self.scales[lvl](self.conv_reg(reg_feat))
            centerness = self.conv_centerness(
                reg_feat if self.centerness_on_reg else cls_feat)
            if self.norm_on_bbox:
                bbox_pred = F.relu(bbox_pred) * self.strides[lvl]
            else:
                bbox_pred = bbox_pred.exp()
            cls_scores.append(cls_score.permute(0, 2, 3, 1))
            bbox_preds.append(bbox_pred.permute(0, 2, 3, 1))
            centernesses.append(centerness.permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds), tuple(centernesses)


def fcos_get_bboxes(head: FCOSHead, cls_scores, bbox_preds, centernesses,
                    img_shapes: torch.Tensor | None = None,
                    scale_factors: torch.Tensor | None = None,
                    nms_pre: int = 1000, score_thr: float = 0.05,
                    iou_threshold: float = 0.6, max_per_img: int = 100,
                    with_nms: bool = True):
    """Batched decode + multiclass NMS with static shapes.

    sigmoid class scores; per level the top ``nms_pre`` points ranked by
    max-class score x centerness; distance2bbox decode (inference-mode
    preds already carry the stride); optional clip to ``img_shapes`` (B, 2)
    (H, W) and division by ``scale_factors`` (B, 4); then multiclass NMS
    with centerness-weighted scores, all images in one batch.

    Head outputs are NHWC per level. Returns dets (B, max_per_img, 5),
    labels (B, max_per_img), valid (B, max_per_img).
    """
    nc = head.num_classes
    batch = cls_scores[0].shape[0]
    device = cls_scores[0].device
    featmap_sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    lvl_points = MlvlPointGenerator(head.strides).grid_points(
        featmap_sizes, device=device)

    all_boxes, all_scores, all_cent = [], [], []
    for lvl in range(len(cls_scores)):
        scores = torch.sigmoid(cls_scores[lvl].reshape(batch, -1, nc))
        cent = torch.sigmoid(centernesses[lvl].reshape(batch, -1))
        bpred = bbox_preds[lvl].reshape(batch, -1, 4)
        hw = scores.shape[1]
        k = min(nms_pre, hw)
        rank = scores.amax(dim=-1) * cent
        top_idx = torch.sort(rank, dim=1, descending=True,
                             stable=True).indices[:, :k]
        scores = torch.take_along_dim(scores, top_idx[..., None], dim=1)
        cent = torch.take_along_dim(cent, top_idx, dim=1)
        bpred = torch.take_along_dim(bpred, top_idx[..., None], dim=1)
        pts = lvl_points[lvl][top_idx]
        boxes = distance2bbox(pts, bpred)
        if img_shapes is not None:
            xlim = img_shapes[:, None, 1:2]
            ylim = img_shapes[:, None, 0:1]
            zero = torch.zeros((), dtype=boxes.dtype, device=device)
            boxes = torch.cat([
                boxes[..., 0:1].clamp(zero, xlim),
                boxes[..., 1:2].clamp(zero, ylim),
                boxes[..., 2:3].clamp(zero, xlim),
                boxes[..., 3:4].clamp(zero, ylim)], dim=-1)
        all_boxes.append(boxes)
        all_scores.append(scores)
        all_cent.append(cent)

    boxes = torch.cat(all_boxes, dim=1)                     # (B, P, 4)
    scores = torch.cat(all_scores, dim=1)                   # (B, P, C)
    cent = torch.cat(all_cent, dim=1)                       # (B, P)
    if scale_factors is not None:
        boxes = boxes / scale_factors[:, None, :]
    if not with_nms:
        return boxes, scores, cent
    # mmdet: score_thr on the RAW scores, centerness multiplies after
    return multiclass_nms(boxes, scores, score_thr=score_thr,
                          iou_threshold=iou_threshold,
                          max_per_img=max_per_img, score_factors=cent)
