"""FCOS head, its DSL loss, and its batched decode + multiclass NMS.

Counterpart of ``dsl_tpu/models/dense_heads/fcos_head.py``: ``FCOSHead``
(4-conv GN(32) cls/reg towers shared over levels, 3x3 predictors, a
learnable Scale per level on the box branch, centerness on the reg tower,
``norm_on_bbox``), ``fcos_loss`` with the three DSL extensions (ignore-region
classification masking, per-source loss weights, the scale-invariant si-soft
term) and ``fcos_get_bboxes``. The towers run NCHW; the head returns NHWC
per level, the JAX package's layout, so that loss and decode flatten
``(y, x, c)`` exactly as it does there.

Submodule names are mmdet's: ``cls_convs.i.{conv,gn}``, ``reg_convs.i``,
``conv_cls``, ``conv_reg``, ``conv_centerness``, ``scales.i``. With
``dcn_on_last_conv`` each tower's last conv is a modulated deformable conv
(DCNv2, ``ops/deform_conv.py``: mmcv's ``conv.weight``, ``conv.bias``,
``conv.conv_offset``), shared over the levels as the plain convs are.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.registry import HEADS
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.boxes import distance2bbox
from dsl_tpu_torch.core.nms import multiclass_nms
from dsl_tpu_torch.core.points import MlvlPointGenerator
from dsl_tpu_torch.core.targets import (
    INF, centerness_target, expand_point_metadata, fcos_targets, ignore_weight)
from dsl_tpu_torch.ops.deform_conv import DeformConv2dPack
from dsl_tpu_torch.parallel.mesh import all_reduce_sum
from dsl_tpu_torch.models.layers import (
    GroupNorm, Scale, bias_init_with_prob, normal_init)


class _TowerConv(nn.Module):
    """conv -> GN -> relu, with mmcv ``ConvModule``'s ``conv``/``gn`` names;
    the conv a DCNv2 one where ``deform``."""

    def __init__(self, cin: int, cout: int, use_bias: bool,
                 deform: bool = False):
        super().__init__()
        self.conv = (DeformConv2dPack(cin, cout, 3, bias=use_bias) if deform
                     else nn.Conv2d(cin, cout, 3, padding=1, bias=use_bias))
        self.gn = GroupNorm(cout, 32)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


DEFAULT_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                          (512, INF))


@HEADS.register
class FCOSHead(nn.Module):
    """The JAX head's fields, by name; an unknown config key raises.

    ``loss_weight`` is the unlabeled source's weight, which the data layer
    puts in the batch's ``source_weight``; ``soft_weight`` and
    ``soft_warm_up`` drive si-soft; ``loss_cls``/``loss_bbox``/
    ``loss_centerness`` are parsed by ``_resolve_loss_cfgs``.
    """

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 regress_ranges: Sequence = DEFAULT_REGRESS_RANGES,
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = True, centerness_on_reg: bool = True,
                 dcn_on_last_conv: bool = False,
                 conv_bias: bool | str = True, loss_weight: float = 1.0,
                 soft_weight: float = 0.0, soft_warm_up: int = 0,
                 loss_cls: dict | None = None, loss_bbox: dict | None = None,
                 loss_centerness: dict | None = None,
                 norm_cfg: dict | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.regress_ranges = [tuple(r) for r in regress_ranges]
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.norm_on_bbox = norm_on_bbox
        self.centerness_on_reg = centerness_on_reg
        self.loss_weight = loss_weight
        self.soft_weight = soft_weight
        self.soft_warm_up = soft_warm_up
        self.loss_cls = loss_cls
        self.loss_bbox = loss_bbox
        self.loss_centerness = loss_centerness
        use_bias = (conv_bias if isinstance(conv_bias, bool)
                    else norm_cfg is None)
        chans = [in_channels] + [feat_channels] * stacked_convs
        last = stacked_convs - 1 if dcn_on_last_conv else -1
        self.cls_convs = nn.ModuleList(
            _TowerConv(chans[i], chans[i + 1], use_bias, i == last)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            _TowerConv(chans[i], chans[i + 1], use_bias, i == last)
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

    def forward(self, feats, training: bool = False):
        """feats: NCHW FPN levels. Returns (cls_scores, bbox_preds,
        centernesses), each a tuple of NHWC tensors with C = num_classes /
        4 / 1. With ``norm_on_bbox``, bbox_preds are relu'd and
        stride-normalized in training and in image pixels otherwise."""
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
                bbox_pred = F.relu(bbox_pred)
                if not training:
                    bbox_pred = bbox_pred * self.strides[lvl]
            else:
                bbox_pred = bbox_pred.exp()
            cls_scores.append(cls_score.permute(0, 2, 3, 1))
            bbox_preds.append(bbox_pred.permute(0, 2, 3, 1))
            centernesses.append(centerness.permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds), tuple(centernesses)


def _flatten_levels(per_level, channels: int) -> torch.Tensor:
    """[(B, H, W, C)] -> (B, P, C), levels concatenated in order."""
    return torch.cat([x.reshape(x.shape[0], -1, channels) for x in per_level],
                     dim=1)


def _resolve_loss_cfgs(head: FCOSHead):
    """Parse the head's loss configs, raising on anything not supported.

    Returns (cls_fn, bbox_fn, cent_fn), each called as
    ``fn(pred, target, weight, avg_factor)`` with its loss_weight folded in.
    Without a ``loss_bbox`` the loss is GIoU, the JAX package's default.
    """
    cls_cfg = dict(head.loss_cls or {})
    cls_type = cls_cfg.pop("type", "FocalLoss")
    if cls_type != "FocalLoss" or not cls_cfg.pop("use_sigmoid", True):
        raise NotImplementedError(
            f"FCOS loss_cls type {cls_type!r} (use_sigmoid=False?) is not "
            "supported; use FocalLoss(use_sigmoid=True)")
    gamma = float(cls_cfg.pop("gamma", 2.0))
    alpha = float(cls_cfg.pop("alpha", 0.25))
    cls_lw = float(cls_cfg.pop("loss_weight", 1.0))
    if cls_cfg:
        raise NotImplementedError(f"unhandled loss_cls keys: {cls_cfg}")

    def cls_fn(logits, labels, weight, avg_factor):
        return cls_lw * L.sigmoid_focal_loss(
            logits, labels, gamma=gamma, alpha=alpha, weight=weight,
            avg_factor=avg_factor)

    bbox_cfg = dict(head.loss_bbox or {"type": "GIoULoss", "loss_weight": 1.0})
    bbox_type = bbox_cfg.pop("type", "IoULoss")
    bbox_lw = float(bbox_cfg.pop("loss_weight", 1.0))
    eps = float(bbox_cfg.pop("eps", 1e-6))
    linear = bool(bbox_cfg.pop("linear", False))
    if bbox_cfg:
        raise NotImplementedError(f"unhandled loss_bbox keys: {bbox_cfg}")
    if bbox_type == "GIoULoss":
        def bbox_fn(pred, tgt, weight, avg_factor):
            return bbox_lw * L.giou_loss(pred, tgt, weight=weight, eps=eps,
                                         avg_factor=avg_factor)
    elif bbox_type == "IoULoss":
        def bbox_fn(pred, tgt, weight, avg_factor):
            # mmdet's iou_loss: max(iou, eps), then -log or 1 - x
            ious = L._iou_for_loss(pred, tgt, "iou", 1e-6)
            ious = torch.maximum(ious, ious.new_full((), eps))
            loss = (1.0 - ious) if linear else -torch.log(ious)
            return bbox_lw * L.weight_reduce_loss(loss, weight, "mean",
                                                  avg_factor)
    else:
        raise NotImplementedError(
            f"FCOS loss_bbox type {bbox_type!r} is not supported "
            "(GIoULoss / IoULoss)")

    cent_cfg = dict(head.loss_centerness or {})
    cent_type = cent_cfg.pop("type", "CrossEntropyLoss")
    if cent_type != "CrossEntropyLoss" or not cent_cfg.pop("use_sigmoid",
                                                           True):
        raise NotImplementedError(
            f"FCOS loss_centerness type {cent_type!r} is not supported; "
            "use CrossEntropyLoss(use_sigmoid=True)")
    cent_lw = float(cent_cfg.pop("loss_weight", 1.0))
    if cent_cfg:
        raise NotImplementedError(
            f"unhandled loss_centerness keys: {cent_cfg}")

    def cent_fn(logits, targets, weight, avg_factor):
        return cent_lw * L.binary_cross_entropy(
            logits, targets, weight=weight, avg_factor=avg_factor)

    return cls_fn, bbox_fn, cent_fn


def fcos_loss(head: FCOSHead, cls_scores, bbox_preds, centernesses,
              batch: dict, cur_iter: int = 0, group=None) -> dict:
    """Dense FCOS loss with the DSL extensions.

    Head outputs are the training-mode NHWC levels in f32. ``batch`` holds
    gt_bboxes (B, K, 4), gt_labels (B, K), gt_valid (B, K), optionally
    ignore_bboxes (B, Ki, 4) with ignore_valid (B, Ki), source_weight (B,)
    (1 for labeled images, the head's ``loss_weight`` for unlabeled ones)
    and si_pair ``dict(full=..., half=...)``, image indices of a full-res
    image and its half-res copy (keep them on the card: an index from the
    host is a copy that waits for it). ``cur_iter`` drives si-soft's
    warm-up. The two normalizers (positive count, centerness sum) are sums
    over the global batch: this batch's where ``group`` is None (one
    process), else summed over the ranks of ``group`` (the sums XLA takes
    over the JAX package's sharded batch). Each rank's losses are then its
    share of the global batch's, and si-soft, the mean over all ranks'
    pairs, takes this rank's pairs' mean over the ranks' count. Returns a
    dict of 0-d loss tensors.
    """
    nc = head.num_classes
    cls_fn, bbox_fn, cent_fn = _resolve_loss_cfgs(head)
    device = cls_scores[0].device
    featmap_sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    points = MlvlPointGenerator(head.strides).flat_points(featmap_sizes, device)
    stride_arr, range_arr = expand_point_metadata(
        featmap_sizes, head.strides, head.regress_ranges, device)
    assign = dict(num_classes=nc, center_sampling=head.center_sampling,
                  center_sample_radius=head.center_sample_radius,
                  norm_on_bbox=head.norm_on_bbox)

    with torch.no_grad():
        labels, bbox_targets = fcos_targets(
            points, range_arr, stride_arr, batch["gt_bboxes"],
            batch["gt_labels"], batch["gt_valid"], **assign)  # (B, P), (B, P, 4)
        b, p = labels.shape
        pos_f = (labels < nc).float()
        num_pos = torch.clamp_min(all_reduce_sum(pos_f.sum(), group), 1.0)
        src_w = batch.get("source_weight")
        src_w_pt = (torch.ones((b, p), device=device) if src_w is None
                    else src_w[:, None].float().expand(b, p))
        cls_w = src_w_pt
        if batch.get("ignore_bboxes") is not None:
            ig_boxes = batch["ignore_bboxes"]
            ig_labels, _ = fcos_targets(
                points, range_arr, stride_arr, ig_boxes,
                torch.full(ig_boxes.shape[:2], nc - 1, device=device),
                batch["ignore_valid"], **assign)
            cls_w = ignore_weight(labels, ig_labels, nc) * src_w_pt
        cent_targets = centerness_target(bbox_targets)          # (B, P)
        centerness_denorm = torch.clamp_min(
            all_reduce_sum((cent_targets * pos_f).sum(), group), 1e-6)
        pts = points[None].expand(b, -1, -1)
        decoded_tgt = distance2bbox(pts, bbox_targets)

    flat_cls = _flatten_levels(cls_scores, nc)                  # (B, P, C)
    flat_bbox = _flatten_levels(bbox_preds, 4)                  # (B, P, 4)
    flat_cent = _flatten_levels(centernesses, 1)[..., 0]        # (B, P)
    out = dict(
        loss_cls=cls_fn(flat_cls, labels, cls_w, num_pos),
        # every point is decoded; negatives weigh 0
        loss_bbox=bbox_fn(distance2bbox(pts, flat_bbox), decoded_tgt,
                          cent_targets * pos_f * src_w_pt, centerness_denorm),
        loss_centerness=cent_fn(flat_cent, cent_targets, pos_f * src_w_pt,
                                num_pos))

    # si-soft: level i of the full-res image against level i-1 of its
    # half-res copy, cropped to level i's size
    si = batch.get("si_pair")
    if si is not None and head.soft_weight != 0.0:
        full = torch.as_tensor(si["full"], device=device).reshape(-1)
        half = torch.as_tensor(si["half"], device=device).reshape(-1)
        loss_sisoft = 0.0
        for i in range(1, len(cls_scores)):
            h, w = cls_scores[i].shape[1:3]
            a = cls_scores[i][full]
            bb = cls_scores[i - 1][half][:, :h, :w, :]
            loss_sisoft = loss_sisoft + ((a - bb) ** 2).mean()
        warm = (head.soft_weight if cur_iter > head.soft_warm_up
                else head.soft_weight / 1000.0)
        if group is not None:
            loss_sisoft = loss_sisoft / dist.get_world_size(group)
        out["loss_sisoft"] = loss_sisoft * warm
    return out


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
