"""RetinaNet head: module, focal loss over MaxIoU-assigned anchors, decode.

Counterpart of ``dsl_tpu/models/dense_heads/retina_head.py``
(``RetinaHead``, ``retina_loss``, ``retina_get_bboxes``): 4 stacked 3x3
convs with relu per branch, no norm (mmdet's names ``cls_convs.i.conv``,
``reg_convs.i.conv``, ``retina_cls``, ``retina_reg``), per-anchor class
logits and box deltas returned NHWC per level (the JAX package's layout);
the loss assigns by MaxIoU (0.5 / 0.4, ``min_pos_iou`` 0, low-quality
match), sigmoid focal loss (gamma 2, alpha 0.25) over the non-ignored
anchors and L1 (or SmoothL1 with its ``beta``, the V1.x configs') on the
positives' encoded targets, both over the positive count (summed over the
ranks of a process group; as in the JAX loss, ``loss_weight`` is not
read); the decode takes each
level's ``nms_pre`` best anchors by their best class score, decodes, clips
and rescales them, then ``multiclass_nms`` (one launch of the NMS kernel
for the batch). ``RetinaSepBNHead`` (NAS-FPN's) shares each tower conv over
the levels with a FrozenBatchNorm per (level, conv). The GHM losses the
JAX function also takes are not ported yet and raise.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import HEADS
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.anchors import anchor_generator_from_cfg
from dsl_tpu_torch.core.assigners import max_iou_assign
from dsl_tpu_torch.core.boxes import clip_to_shapes, resolve_delta_coder
from dsl_tpu_torch.core.nms import _gather_rows, _sort_desc, multiclass_nms
from dsl_tpu_torch.models.layers import (
    FrozenBatchNorm, bias_init_with_prob, normal_init)
from dsl_tpu_torch.parallel.mesh import all_reduce_sum


class _Conv(nn.Module):
    """A 3x3 conv with mmcv ``ConvModule``'s ``conv`` name (no norm)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv(x))


@HEADS.register
class RetinaHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                 min_pos_iou: float = 0.0, loss_cls: dict | None = None,
                 loss_bbox: dict | None = None,
                 anchor_generator: dict | None = None,
                 bbox_coder: dict | None = None):
        super().__init__()
        cls_type = dict(loss_cls or {}).get("type", "FocalLoss")
        bbox_type = dict(loss_bbox or {}).get("type", "L1Loss")
        if cls_type != "FocalLoss":
            raise NotImplementedError(f"RetinaHead loss_cls {cls_type} is not "
                                      f"ported yet")
        if bbox_type not in ("L1Loss", "SmoothL1Loss", "BalancedL1Loss"):
            raise NotImplementedError(f"RetinaHead loss_bbox {bbox_type} is "
                                      f"not ported yet")
        resolve_delta_coder(bbox_coder)
        self.num_classes = num_classes
        self.strides = list(strides)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.bbox_coder = bbox_coder
        self.loss_cls = loss_cls
        self.loss_bbox = loss_bbox
        self.anchors = anchor_generator_from_cfg(
            anchor_generator, strides=self.strides, ratios=list(anchor_ratios),
            octave_base_scale=octave_base_scale,
            scales_per_octave=scales_per_octave)
        num_anchors = self.anchors.num_base_anchors
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(_Conv(chans[i], chans[i + 1])
                                       for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(_Conv(chans[i], chans[i + 1])
                                       for i in range(stacked_convs))
        self.retina_cls = nn.Conv2d(feat_channels, num_anchors * num_classes,
                                    3, padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, num_anchors * 4, 3, padding=1)

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_init(m, 0.01, generator=generator)
        normal_init(self.retina_cls, 0.01, bias_init_with_prob(0.01), generator)

    def forward(self, feats, training: bool = False):
        """feats: NCHW FPN levels -> (cls_scores, bbox_preds), tuples of
        NHWC tensors with A*C and 4A channels."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            cf, rf = x, x
            for conv in self.cls_convs:
                cf = conv(cf)
            for conv in self.reg_convs:
                rf = conv(rf)
            cls_scores.append(self.retina_cls(cf).permute(0, 2, 3, 1))
            bbox_preds.append(self.retina_reg(rf).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds)


class _SepBNConv(nn.Module):
    """mmcv ``ConvModule`` of a shared 3x3 conv (no bias) and this
    level's FrozenBatchNorm, then a relu."""

    def __init__(self, conv: nn.Conv2d, channels: int):
        super().__init__()
        self.conv = conv
        self.bn = FrozenBatchNorm(channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


@HEADS.register
class RetinaSepBNHead(RetinaHead):
    """NAS-FPN's Retina head, as the JAX package's ``RetinaSepBNHead``:
    the tower convs (3x3, no bias) are shared over the ``num_ins`` levels,
    each level with its own FrozenBatchNorm after each conv. The names are
    mmdet's: ``cls_convs.{level}.{i}.conv`` (one module under every level,
    as mmdet ties them) and ``.bn``; the predictors are RetinaNet's."""

    def __init__(self, num_ins: int = 5, **kwargs):
        super().__init__(**kwargs)
        stacked = len(self.cls_convs)
        chans = [kwargs.get("in_channels", 256)] + [
            kwargs.get("feat_channels", 256)] * stacked
        self.num_ins = num_ins

        def towers():
            shared = [nn.Conv2d(chans[i], chans[i + 1], 3, padding=1,
                                bias=False) for i in range(stacked)]
            return nn.ModuleList(
                nn.ModuleList(_SepBNConv(shared[i], chans[i + 1])
                              for i in range(stacked))
                for _ in range(num_ins))

        self.cls_convs = towers()
        self.reg_convs = towers()

    def forward(self, feats, training: bool = False):
        if len(feats) != self.num_ins:
            raise ValueError(f"RetinaSepBNHead: {len(feats)} levels for "
                             f"num_ins {self.num_ins}")
        cls_scores, bbox_preds = [], []
        for x, cls_tower, reg_tower in zip(feats, self.cls_convs,
                                           self.reg_convs):
            cf, rf = x, x
            for conv in cls_tower:
                cf = conv(cf)
            for conv in reg_tower:
                rf = conv(rf)
            cls_scores.append(self.retina_cls(cf).permute(0, 2, 3, 1))
            bbox_preds.append(self.retina_reg(rf).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds)


def retina_loss(head: RetinaHead, cls_scores, bbox_preds, batch: dict,
                group=None) -> dict:
    """Focal + L1 over MaxIoU-assigned anchors; the positive count is the
    global batch's (summed over ``group``'s ranks where there is one)."""
    nc = head.num_classes
    sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    anchors = head.anchors.flat_anchors(sizes, cls_scores[0].device)
    labels, assigned, weights, _ = max_iou_assign(
        anchors, batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"],
        pos_iou_thr=head.pos_iou_thr, neg_iou_thr=head.neg_iou_thr,
        min_pos_iou=head.min_pos_iou, num_classes=nc)
    b = labels.shape[0]
    flat_cls = torch.cat([c.reshape(b, -1, nc) for c in cls_scores], dim=1)
    flat_reg = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], dim=1)
    pos = labels < nc
    num_pos = torch.clamp_min(
        all_reduce_sum(pos.to(torch.float32).sum(), group), 1.0)
    loss_cls = L.sigmoid_focal_loss(flat_cls, labels, weight=weights,
                                    avg_factor=num_pos)
    gt = _gather_rows(batch["gt_bboxes"], assigned.clamp_min(0))
    enc, _, means, stds = resolve_delta_coder(
        head.bbox_coder, head.target_means, head.target_stds)
    deltas = enc(anchors[None], gt, means, stds)
    bbox_cfg = dict(head.loss_bbox or {})
    posw = pos.to(torch.float32)[..., None]
    if bbox_cfg.get("type") == "BalancedL1Loss":
        loss_bbox = L.balanced_l1_loss(
            flat_reg, deltas, weight=posw, avg_factor=num_pos,
            alpha=float(bbox_cfg.get("alpha", 0.5)),
            gamma=float(bbox_cfg.get("gamma", 1.5)),
            beta=float(bbox_cfg.get("beta", 1.0)))
    elif bbox_cfg.get("type", "L1Loss") == "SmoothL1Loss":
        loss_bbox = L.smooth_l1_loss(flat_reg, deltas,
                                     beta=float(bbox_cfg.get("beta", 1.0)),
                                     weight=posw, avg_factor=num_pos)
    else:
        loss_bbox = L.l1_loss(flat_reg, deltas, weight=posw,
                              avg_factor=num_pos)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)


@torch.no_grad()
def retina_get_bboxes(head: RetinaHead, cls_scores, bbox_preds,
                      img_shapes=None, scale_factors=None, nms_pre: int = 1000,
                      score_thr: float = 0.05, iou_threshold: float = 0.5,
                      max_per_img: int = 100):
    """Batched decode + multiclass NMS. Returns dets (B, max_per_img, 5),
    labels, valid."""
    nc = head.num_classes
    sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    lvl_anchors = head.anchors.grid_anchors(sizes, cls_scores[0].device)
    b = cls_scores[0].shape[0]
    _, dec, means, stds = resolve_delta_coder(
        head.bbox_coder, head.target_means, head.target_stds)
    boxes_all, scores_all = [], []
    for lvl, (cs, bp) in enumerate(zip(cls_scores, bbox_preds)):
        scores = torch.sigmoid(cs.reshape(b, -1, nc))
        reg = bp.reshape(b, -1, 4)
        k = min(nms_pre, scores.shape[1])
        _, top = _sort_desc(scores.amax(dim=-1), k)
        boxes = dec(lvl_anchors[lvl][top], _gather_rows(reg, top), means, stds)
        if img_shapes is not None:
            boxes = clip_to_shapes(boxes, img_shapes)
        boxes_all.append(boxes)
        scores_all.append(_gather_rows(scores, top))
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    if scale_factors is not None:
        boxes = boxes / scale_factors[:, None, :]
    return multiclass_nms(boxes, scores, score_thr=score_thr,
                          iou_threshold=iou_threshold, max_per_img=max_per_img)
