"""MaxIoU assignment over dense anchors, batched over images.

Counterpart of ``dsl_tpu/core/assigners.py::max_iou_assign`` (which vmaps
``_max_iou_assign_single`` over images): every result is a dense
per-anchor tensor (labels with ``num_classes`` as background, the assigned
GT index or -1, a weight of 1 for a positive or a negative and 0 for an
anchor between the thresholds, the max IoU), nothing of dynamic length.

Ties are broken as JAX breaks them: ``argmax`` takes the first maximum
(``torch.argmax`` does too), and a forced low-quality match goes to the
last GT whose best the anchor is, as the reference's loop over GTs
overwrites. With ``gt_max_assign_all=False`` (SSD) only each GT's first
best anchor is forced, not every anchor tied at its best. ``inside``
(the RPN's ``allowed_border`` filter) takes the anchors outside an image
out of the assignment: background, weight 0, never a GT's best. ATSS is
not ported yet.
"""

from __future__ import annotations

import torch

from dsl_tpu_torch.core.boxes import bbox_overlaps


def max_iou_assign_single(anchors, gt_bboxes, gt_labels, gt_valid,
                          pos_iou_thr: float, neg_iou_thr: float,
                          min_pos_iou: float, num_classes: int,
                          match_low_quality: bool,
                          gt_max_assign_all: bool = True,
                          inside: torch.Tensor | None = None):
    """One image's assignment, or a batch's where every argument but
    ``anchors`` has a leading batch axis: anchors (..., A, 4), gt_bboxes
    (..., K, 4), gt_labels (..., K), gt_valid (..., K) bool, inside
    optional (..., A) bool.

    Returns labels (..., A) int64, assigned (..., A) int64, weights
    (..., A) f32, max_iou (..., A) f32.
    """
    neg1 = gt_bboxes.new_full((), -1.0)
    ious = bbox_overlaps(anchors, gt_bboxes)                    # (..., A, K)
    ious = torch.where(gt_valid[..., None, :], ious, neg1)
    if inside is not None:
        ious = torch.where(inside[..., None], ious, neg1)
    max_iou = ious.amax(dim=-1)
    argmax = ious.argmax(dim=-1)          # the first maximum, as jnp.argmax

    is_pos = max_iou >= pos_iou_thr
    is_neg = (max_iou < neg_iou_thr) & (max_iou >= 0)

    if match_low_quality:
        gt_best_iou = ious.amax(dim=-2)                    # (..., K)
        if gt_max_assign_all:
            is_best = ious == gt_best_iou[..., None, :]
        else:
            # only the GT's first best anchor (jnp.argmax over the anchors)
            best_anchor = ious.argmax(dim=-2)              # (..., K)
            arange = torch.arange(ious.shape[-2], device=ious.device)
            is_best = arange[:, None] == best_anchor[..., None, :]
        is_best = (is_best
                   & (gt_best_iou[..., None, :] >= min_pos_iou)
                   & gt_valid[..., None, :])
        forced = is_best.any(dim=-1)
        kk = is_best.shape[-1]
        forced_gt = (kk - 1) - is_best.flip(-1).to(torch.uint8).argmax(dim=-1)
        argmax = torch.where(forced, forced_gt, argmax)
        is_pos = is_pos | forced
        is_neg = is_neg & ~forced

    labels = torch.where(is_pos, torch.gather(gt_labels, -1, argmax),
                         torch.full_like(argmax, num_classes))
    weights = (is_pos | is_neg).to(torch.float32)
    assigned = torch.where(is_pos, argmax, torch.full_like(argmax, -1))
    return labels, assigned, weights, max_iou


def max_iou_assign(anchors, gt_bboxes, gt_labels, gt_valid,
                   pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                   min_pos_iou: float = 0.0, num_classes: int = 80,
                   match_low_quality: bool = True,
                   gt_max_assign_all: bool = True,
                   inside: torch.Tensor | None = None):
    """Batched MaxIoU assignment: anchors (A, 4) shared by the images,
    gt_* (B, K, ...), inside optional (B, A) per image. Returns labels,
    assigned, weights, max_iou, each (B, A)."""
    b = gt_bboxes.shape[0]
    return max_iou_assign_single(
        anchors.expand(b, *anchors.shape), gt_bboxes,
        gt_labels.to(torch.int64), gt_valid, pos_iou_thr=pos_iou_thr,
        neg_iou_thr=neg_iou_thr, min_pos_iou=min_pos_iou,
        num_classes=num_classes, match_low_quality=match_low_quality,
        gt_max_assign_all=gt_max_assign_all, inside=inside)


def anchor_inside_flags(anchors: torch.Tensor, img_shapes: torch.Tensor,
                        allowed_border: float) -> torch.Tensor:
    """(B, A) whether each anchor lies within its image's (H, W) grown by
    ``allowed_border`` (mmdet's ``anchor_inside_flags``, as the JAX RPN
    loss computes it)."""
    h = img_shapes[:, 0:1]
    w = img_shapes[:, 1:2]
    return ((anchors[None, :, 0] >= -allowed_border)
            & (anchors[None, :, 1] >= -allowed_border)
            & (anchors[None, :, 2] < w + allowed_border)
            & (anchors[None, :, 3] < h + allowed_border))
