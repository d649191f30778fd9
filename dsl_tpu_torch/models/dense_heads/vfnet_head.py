"""VarifocalNet (VFNet) head: module, loss and decode.

Counterpart of ``dsl_tpu/models/dense_heads/vfnet_head.py``
(``star_dcn_offset``, ``VFNetHead``, ``vfnet_loss``, ``vfnet_get_bboxes``):
FCOS-style GN towers shared over the levels (the last conv of each a
DCNv2 with ``dcn_on_last_conv``); from the reg tower a conv-GN-relu, the
initial (l, t, r, b) prediction ``exp(scale * conv) * stride``; the nine
star points of that box as the offsets of two deformable 3x3 convs, one
on each tower (their offsets see the box's gradient at ``gradient_mul``,
the rest detached); the refined box ``exp(scale_refine * conv) *
initial.detach()`` and the IoU-aware class logits. The towers run NCHW;
the head returns NHWC per level, the JAX package's layout.

The loss assigns by ATSS on one square anchor per point (``anchor_scale``
x stride, centred on the point: ``center_offset`` 0, and the points at
``offset`` 0, as the JAX package lays them), GIoU on the initial and on
the refined boxes weighted by each positive's (detached) IoU with its GT
over their sums, and the Varifocal loss against the refined IoU at the
assigned class over the positive count; the sums are over the ranks of a
process group where one is given (the JAX package's ``psum``). The
decode takes each level's ``nms_pre`` points by their best class score
(ties to the lower index, as ``jax.lax.top_k``), the refined boxes, then
``multiclass_nms`` (one launch of the NMS kernel for the batch).

Submodule names are mmdet's: ``cls_convs.i.{conv,gn}``, ``reg_convs.i``,
``vfnet_reg_conv.{conv,gn}``, ``vfnet_reg``, ``vfnet_reg_refine_dconv``,
``vfnet_reg_refine``, ``vfnet_cls_dconv``, ``vfnet_cls``, ``scales.i``,
``scales_refine.i``. As the JAX head builds them, the towers' convs and
``vfnet_reg_conv`` carry biases (mmdet's GN towers have none).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.anchors import AnchorGenerator
from dsl_tpu_torch.core.assigners import atss_assign
from dsl_tpu_torch.core.boxes import bbox_overlaps, distance2bbox
from dsl_tpu_torch.core.nms import _gather_rows, _sort_desc, multiclass_nms
from dsl_tpu_torch.core.points import MlvlPointGenerator
from dsl_tpu_torch.models.dense_heads.fcos_head import _TowerConv
from dsl_tpu_torch.models.layers import (
    GroupNorm, Scale, bias_init_with_prob, he_normal_, normal_init)
from dsl_tpu_torch.ops.deform_conv import DeformConv2d
from dsl_tpu_torch.parallel.mesh import all_reduce_sum
from dsl_tpu_torch.registry import HEADS

# the base grid (dy, dx) of a 3x3 kernel's taps, row-major
_BASE = [(-1.0, -1.0), (-1.0, 0.0), (-1.0, 1.0),
         (0.0, -1.0), (0.0, 0.0), (0.0, 1.0),
         (1.0, -1.0), (1.0, 0.0), (1.0, 1.0)]


def star_dcn_offset(bbox_pred: torch.Tensor, gradient_mul: float,
                    stride: float) -> torch.Tensor:
    """(B, 4, H, W) initial (l, t, r, b) boxes -> (B, 18, H, W) offsets of
    a 3x3 deformable conv (mmcv's (dy, dx) per tap) that move its taps to
    the box's corners, edge midpoints and centre: the star points less the
    base grid, from ``(1 - g) * pred.detach() + g * pred`` over the
    stride."""
    p = (1 - gradient_mul) * bbox_pred.detach() + gradient_mul * bbox_pred
    p = p / stride
    left, top, right, bottom = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    z = torch.zeros_like(left)
    star = [(-top, -left), (-top, z), (-top, right),
            (z, -left), (z, z), (z, right),
            (bottom, -left), (bottom, z), (bottom, right)]
    chans = []
    for (dy, dx), (by, bx) in zip(star, _BASE):
        chans.append(dy - by)
        chans.append(dx - bx)
    return torch.stack(chans, dim=1)


class _ConvGN(nn.Module):
    """conv -> GN -> relu (``vfnet_reg_conv``: mmcv ``ConvModule`` names)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.gn = GroupNorm(channels, 32)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


@HEADS.register
class VFNetHead(nn.Module):
    """The JAX head's fields, by name; an unknown config key raises.
    ``loss_cls`` / ``loss_bbox`` / ``loss_bbox_refine`` are read by
    :func:`vfnet_loss` (their ``loss_weight``), as in the JAX package."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gradient_mul: float = 0.1, anchor_scale: float = 8.0,
                 atss_topk: int = 9, loss_bbox_weight: float = 1.5,
                 loss_bbox_refine_weight: float = 2.0,
                 dcn_on_last_conv: bool = False,
                 loss_cls: dict | None = None, loss_bbox: dict | None = None,
                 loss_bbox_refine: dict | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.strides = list(strides)
        self.gradient_mul = gradient_mul
        self.anchor_scale = anchor_scale
        self.atss_topk = atss_topk
        self.loss_bbox_weight = loss_bbox_weight
        self.loss_bbox_refine_weight = loss_bbox_refine_weight
        self.loss_cls = loss_cls
        self.loss_bbox = loss_bbox
        self.loss_bbox_refine = loss_bbox_refine
        chans = [in_channels] + [feat_channels] * stacked_convs
        last = stacked_convs - 1 if dcn_on_last_conv else -1
        self.cls_convs = nn.ModuleList(
            _TowerConv(chans[i], chans[i + 1], True, i == last)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            _TowerConv(chans[i], chans[i + 1], True, i == last)
            for i in range(stacked_convs))
        self.vfnet_reg_conv = _ConvGN(feat_channels)
        self.vfnet_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.vfnet_reg_refine_dconv = DeformConv2d(feat_channels, feat_channels)
        self.vfnet_reg_refine = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.vfnet_cls_dconv = DeformConv2d(feat_channels, feat_channels)
        self.vfnet_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.scales = nn.ModuleList(Scale(1.0) for _ in self.strides)
        self.scales_refine = nn.ModuleList(Scale(1.0) for _ in self.strides)

    def make_anchor_generator(self) -> AnchorGenerator:
        return AnchorGenerator(strides=self.strides, ratios=(1.0,),
                               scales=(self.anchor_scale,), center_offset=0.0)

    def init_weights(self, generator: torch.Generator | None = None):
        """The JAX head's init: the convs (the towers' DCNv2 kernels too)
        normal 0.01 with zero biases, the classifier's bias at prior 0.01,
        the star convs' kernels He-normal."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_init(m, 0.01, generator=generator)
        normal_init(self.vfnet_cls, 0.01, bias_init_with_prob(0.01), generator)
        he_normal_(self.vfnet_reg_refine_dconv.weight, generator)
        he_normal_(self.vfnet_cls_dconv.weight, generator)

    def forward(self, feats, training: bool = False):
        """feats: NCHW FPN levels. Returns (cls_scores, bbox_preds,
        bbox_refines), each a tuple of NHWC tensors with C = num_classes /
        4 / 4; the boxes (l, t, r, b) in image pixels. ``training`` is
        accepted for the detectors' call and changes nothing, as in the
        JAX head."""
        cls_out, bbox_out, refine_out = [], [], []
        for lvl, x in enumerate(feats):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            reg_init = self.vfnet_reg_conv(reg_feat)
            stride = float(self.strides[lvl])
            bbox_pred = torch.exp(self.scales[lvl](self.vfnet_reg(reg_init))) \
                * stride
            offsets = star_dcn_offset(bbox_pred, self.gradient_mul, stride)
            reg_ref = F.relu(self.vfnet_reg_refine_dconv(reg_feat, offsets))
            bbox_ref = torch.exp(self.scales_refine[lvl](
                self.vfnet_reg_refine(reg_ref))) * bbox_pred.detach()
            cls_star = F.relu(self.vfnet_cls_dconv(cls_feat, offsets))
            cls_out.append(self.vfnet_cls(cls_star).permute(0, 2, 3, 1))
            bbox_out.append(bbox_pred.permute(0, 2, 3, 1))
            refine_out.append(bbox_ref.permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(bbox_out), tuple(refine_out)


def _loss_weights(head: VFNetHead) -> tuple[float, float, float]:
    """(cls, bbox, refine) loss weights from the head's loss configs (the
    JAX function's reading: the types checked, ``loss_weight`` taken)."""
    cls_cfg = dict(head.loss_cls or {})
    if cls_cfg.get("type", "VarifocalLoss") != "VarifocalLoss":
        raise NotImplementedError(
            f"VFNet loss_cls {cls_cfg.get('type')!r} unsupported")
    bbox_cfg = dict(head.loss_bbox or {})
    refine_cfg = dict(head.loss_bbox_refine or {})
    for c in (bbox_cfg, refine_cfg):
        if c.get("type", "GIoULoss") != "GIoULoss":
            raise NotImplementedError(
                f"VFNet loss_bbox {c.get('type')!r} unsupported")
    return (float(cls_cfg.get("loss_weight", 1.0)),
            float(bbox_cfg.get("loss_weight", head.loss_bbox_weight)),
            float(refine_cfg.get("loss_weight",
                                 head.loss_bbox_refine_weight)))


def vfnet_loss(head: VFNetHead, cls_scores, bbox_preds, bbox_refines,
               batch: dict, group=None) -> dict:
    """The VFNet loss on the training-mode NHWC levels (f32) and a batch of
    padded GT (gt_bboxes (B, K, 4), gt_labels (B, K), gt_valid (B, K)).
    The positive count and the two IoU sums are summed over the ranks of
    ``group`` where one is given. Returns loss_cls, loss_bbox and
    loss_bbox_rf, 0-d tensors."""
    nc = head.num_classes
    cls_w, bbox_w, refine_w = _loss_weights(head)
    device = cls_scores[0].device
    shapes = [tuple(c.shape[1:3]) for c in cls_scores]
    gen = head.make_anchor_generator()
    anchors = gen.flat_anchors(shapes, device)
    per_level = [h * w * gen.num_base_anchors for h, w in shapes]
    b = cls_scores[0].shape[0]
    with torch.no_grad():
        labels, assigned, _, _ = atss_assign(
            anchors, per_level, batch["gt_bboxes"], batch["gt_labels"],
            batch["gt_valid"], topk=head.atss_topk, num_classes=nc)
        pts = MlvlPointGenerator(head.strides, offset=0.0).flat_points(
            shapes, device)[None].expand(b, -1, -1)
        pos = (labels < nc).float()
        num_pos = torch.clamp_min(all_reduce_sum(pos.sum(), group), 1.0)
        gt = _gather_rows(batch["gt_bboxes"], assigned.clamp_min(0))
    flat_cls = torch.cat([c.reshape(b, -1, nc) for c in cls_scores], dim=1)
    flat_ini = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], dim=1)
    flat_ref = torch.cat([r.reshape(b, -1, 4) for r in bbox_refines], dim=1)
    dec_ini = distance2bbox(pts, flat_ini)
    dec_ref = distance2bbox(pts, flat_ref)
    with torch.no_grad():
        iou_ini = bbox_overlaps(dec_ini, gt, is_aligned=True) * pos
        iou_ref = bbox_overlaps(dec_ref, gt, is_aligned=True) * pos
        denom_ini = torch.clamp_min(all_reduce_sum(iou_ini.sum(), group), 1e-6)
        denom_ref = torch.clamp_min(all_reduce_sum(iou_ref.sum(), group), 1e-6)
        classes = torch.arange(nc, device=device)
        onehot = (labels.clamp(0, nc - 1)[..., None] == classes).float()
        cls_t = onehot * iou_ref[..., None] * pos[..., None]
    return dict(
        loss_cls=cls_w * L.varifocal_loss(flat_cls, cls_t, avg_factor=num_pos),
        loss_bbox=bbox_w * L.giou_loss(dec_ini, gt, weight=iou_ini,
                                       avg_factor=denom_ini),
        loss_bbox_rf=refine_w * L.giou_loss(dec_ref, gt, weight=iou_ref,
                                            avg_factor=denom_ref))


def vfnet_get_bboxes(head: VFNetHead, cls_scores, bbox_preds, bbox_refines,
                     img_shapes: torch.Tensor | None = None,
                     scale_factors: torch.Tensor | None = None,
                     nms_pre: int = 1000, score_thr: float = 0.05,
                     iou_threshold: float = 0.6, max_per_img: int = 100):
    """Decode the refined boxes with the sigmoid (IoU-aware) class scores:
    per level the ``nms_pre`` points of best class score, ``distance2bbox``
    at the points, clipped to ``img_shapes`` (B, 2) and divided by
    ``scale_factors`` (B, 4), then multiclass NMS. Head outputs are NHWC
    per level. Returns dets (B, max_per_img, 5), labels, valid."""
    nc = head.num_classes
    b = cls_scores[0].shape[0]
    device = cls_scores[0].device
    shapes = [tuple(c.shape[1:3]) for c in cls_scores]
    lvl_pts = MlvlPointGenerator(head.strides, offset=0.0).grid_points(
        shapes, device=device)
    boxes_all, scores_all = [], []
    for lvl in range(len(cls_scores)):
        scores = torch.sigmoid(cls_scores[lvl].reshape(b, -1, nc))
        pred = bbox_refines[lvl].reshape(b, -1, 4)
        k = min(nms_pre, scores.shape[1])
        top = _sort_desc(scores.amax(dim=-1), k)[1]
        scores = _gather_rows(scores, top)
        box = distance2bbox(lvl_pts[lvl][top], _gather_rows(pred, top))
        if img_shapes is not None:
            xlim = img_shapes[:, None, 1:2].to(box.dtype)
            ylim = img_shapes[:, None, 0:1].to(box.dtype)
            zero = torch.zeros((), dtype=box.dtype, device=device)
            box = torch.cat([
                torch.minimum(torch.maximum(box[..., 0:1], zero), xlim),
                torch.minimum(torch.maximum(box[..., 1:2], zero), ylim),
                torch.minimum(torch.maximum(box[..., 2:3], zero), xlim),
                torch.minimum(torch.maximum(box[..., 3:4], zero), ylim)],
                dim=-1)
        boxes_all.append(box)
        scores_all.append(scores)
    boxes = torch.cat(boxes_all, dim=1)
    scores = torch.cat(scores_all, dim=1)
    if scale_factors is not None:
        boxes = boxes / scale_factors[:, None, :]
    return multiclass_nms(boxes, scores, score_thr=score_thr,
                          iou_threshold=iou_threshold,
                          max_per_img=max_per_img)
