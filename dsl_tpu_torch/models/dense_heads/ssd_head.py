"""SSD head: per-level conv predictors, hard-negative mining, decode.

Counterpart of ``dsl_tpu/models/dense_heads/ssd_head.py`` (``SSDHead``,
``ssd_loss``, ``ssd_get_bboxes``):

- ``SSDHead``: one 3x3 classifier (A x (C+1) channels, the background
  last) and one 3x3 regressor (4A) per level, no tower; A per level comes
  from the anchor generator (4/6/6/6/4/4 on SSD's ladder). Outputs are
  NHWC per level, the JAX package's layout; module names
  ``cls_convs.i.conv``, ``reg_convs.i.conv``;
- ``ssd_loss``: MaxIoU assignment (0.5 / 0.5, ``min_pos_iou`` 0, only each
  GT's first best anchor forced: ``gt_max_assign_all=False``), softmax CE
  over C+1 classes with 3:1 hard-negative mining as the JAX package mines:
  per image the negatives' losses sorted, the threshold the one at index
  ``clip(3 * n_pos, 1, A - 1)``, and only negatives strictly above it kept
  (negatives tied at the threshold are dropped); smooth-L1 (beta 1) on the
  positives' encoded deltas; both over the positive count, summed over a
  process group's ranks where there is one;
- ``ssd_get_bboxes``: per level the softmax, the ``nms_pre`` best anchors by
  their best class score (ties to the lower index), decode, clip, rescale,
  then ``multiclass_nms`` (one launch of the NMS kernel for the batch, at
  N = ``pre_nms_top`` = 2000 candidates).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dsl_tpu_torch.registry import HEADS
from dsl_tpu_torch.core import losses as L
from dsl_tpu_torch.core.anchors import anchor_generator_from_cfg
from dsl_tpu_torch.core.assigners import max_iou_assign
from dsl_tpu_torch.core.boxes import clip_to_shapes, resolve_delta_coder
from dsl_tpu_torch.core.nms import _gather_rows, _sort_desc, multiclass_nms
from dsl_tpu_torch.models.layers import normal_init
from dsl_tpu_torch.parallel.mesh import all_reduce_sum


class _Pred(nn.Module):
    """A bare 3x3 conv under mmcv ``ConvModule``'s ``conv`` name."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        return self.conv(x)


@HEADS.register
class SSDHead(nn.Module):
    def __init__(self, num_classes: int = 80,
                 in_channels: Sequence[int] = (256, 256, 256, 256, 256),
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_scales: Sequence[float] = (4.0, 8.0),
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 neg_pos_ratio: int = 3, pos_iou_thr: float = 0.5,
                 neg_iou_thr: float = 0.5,
                 anchor_generator: dict | None = None,
                 bbox_coder: dict | None = None):
        super().__init__()
        resolve_delta_coder(bbox_coder)            # an unknown coder raises
        self.num_classes = num_classes
        self.strides = list(strides)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.neg_pos_ratio = neg_pos_ratio
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.bbox_coder = bbox_coder
        self.anchors = anchor_generator_from_cfg(
            anchor_generator, strides=self.strides,
            ratios=list(anchor_ratios), scales=list(anchor_scales))
        counts = [self.anchors.num_base_anchors_level(i)
                  for i in range(len(in_channels))]
        self.cls_convs = nn.ModuleList(
            _Pred(c, a * (num_classes + 1)) for c, a in zip(in_channels, counts))
        self.reg_convs = nn.ModuleList(
            _Pred(c, a * 4) for c, a in zip(in_channels, counts))

    def init_weights(self, generator: torch.Generator | None = None):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                normal_init(m, 0.01, generator=generator)

    def forward(self, feats, training: bool = False):
        """feats: NCHW levels -> (cls_scores, bbox_preds), tuples of NHWC
        tensors with A*(C+1) and 4A channels."""
        cls_scores = tuple(conv(x).permute(0, 2, 3, 1)
                           for conv, x in zip(self.cls_convs, feats))
        bbox_preds = tuple(conv(x).permute(0, 2, 3, 1)
                           for conv, x in zip(self.reg_convs, feats))
        return cls_scores, bbox_preds


def hard_negative_weights(ce: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, num_classes: int,
                          neg_pos_ratio: int) -> torch.Tensor:
    """(B, A) 0/1 weights of the kept negatives: per image the negatives'
    losses sorted descending, the threshold at index ``clip(ratio * n_pos,
    1, A - 1)``, and the negatives strictly above it."""
    a = labels.shape[1]
    neg_mask = (labels == num_classes) & (weights > 0)
    neg_loss = torch.where(neg_mask, ce, ce.new_full((), -1e30))
    n_pos = (labels < num_classes).to(torch.float32).sum(dim=1)
    sorted_neg = torch.sort(neg_loss, dim=1, descending=True).values
    idx = (neg_pos_ratio * n_pos).to(torch.int32).clamp(1, a - 1)
    thresh = torch.gather(sorted_neg, 1, idx[:, None].to(torch.int64))
    return (neg_mask & (neg_loss > thresh)).to(torch.float32)


def ssd_loss(head: SSDHead, cls_scores, bbox_preds, batch: dict,
             group=None) -> dict:
    nc = head.num_classes
    sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    anchors = head.anchors.flat_anchors(sizes, cls_scores[0].device)
    labels, assigned, weights, _ = max_iou_assign(
        anchors, batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"],
        pos_iou_thr=head.pos_iou_thr, neg_iou_thr=head.neg_iou_thr,
        min_pos_iou=0.0, num_classes=nc, gt_max_assign_all=False)
    b = labels.shape[0]
    flat_cls = torch.cat([c.reshape(b, -1, nc + 1) for c in cls_scores], dim=1)
    flat_reg = torch.cat([r.reshape(b, -1, 4) for r in bbox_preds], dim=1)
    pos_f = (labels < nc).to(torch.float32)
    num_pos = torch.clamp_min(all_reduce_sum(pos_f.sum(), group), 1.0)
    ce = L.cross_entropy(flat_cls, labels, reduction="none")      # (B, A)
    keep_neg = hard_negative_weights(ce.detach(), labels, weights, nc,
                                     head.neg_pos_ratio)
    loss_cls = (ce * (pos_f + keep_neg)).sum() / num_pos
    gt = _gather_rows(batch["gt_bboxes"], assigned.clamp_min(0))
    enc, _, means, stds = resolve_delta_coder(
        head.bbox_coder, head.target_means, head.target_stds)
    tgt = enc(anchors[None], gt, means, stds)
    loss_bbox = L.smooth_l1_loss(flat_reg, tgt, beta=1.0,
                                 weight=pos_f[..., None], avg_factor=num_pos)
    return dict(loss_cls=loss_cls, loss_bbox=loss_bbox)


@torch.no_grad()
def ssd_get_bboxes(head: SSDHead, cls_scores, bbox_preds, img_shapes=None,
                   scale_factors=None, nms_pre: int = 1000,
                   score_thr: float = 0.02, iou_threshold: float = 0.45,
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
        scores = torch.softmax(cs.reshape(b, -1, nc + 1), dim=-1)[..., :nc]
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
