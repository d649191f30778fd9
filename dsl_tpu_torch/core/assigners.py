"""MaxIoU and ATSS assignment over dense anchors, batched over images.

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
out of the assignment: background, weight 0, never a GT's best.

``atss_assign`` is ``dsl_tpu/core/assigners.py::atss_assign``: per level
the anchors at most as far from a GT's centre as its k-th nearest (every
anchor tied at the k-th distance counts, so a level can give more than
k), the IoU threshold mean + std over those candidates (the mean over the
candidates alone, as ``jnp.nanmean`` over a NaN-masked array), positives
where the IoU reaches it and the anchor's centre lies strictly inside the
GT, each positive taking its first best GT.
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


def atss_assign(anchors, num_anchors_per_level, gt_bboxes, gt_labels,
                gt_valid, topk: int = 9, num_classes: int = 80):
    """Batched ATSS: anchors (A, 4) shared by the images, levels of
    ``num_anchors_per_level`` anchors in order, gt_* (B, K, ...) padded
    (gt_valid (B, K) bool). Returns labels (B, A) int64 (``num_classes``
    for background), assigned (B, A) int64 (-1 for background), weights
    (B, A) f32 (ones) and the IoU (B, A): the assigned GT's where positive,
    else the best over the GTs (padded ones at 0)."""
    b = gt_bboxes.shape[0]
    zero = gt_bboxes.new_zeros(())
    ious = bbox_overlaps(anchors.expand(b, *anchors.shape), gt_bboxes)
    ious = torch.where(gt_valid[:, None, :], ious, zero)        # (B, A, K)
    acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gcx = (gt_bboxes[..., 0] + gt_bboxes[..., 2]) * 0.5
    gcy = (gt_bboxes[..., 1] + gt_bboxes[..., 3]) * 0.5
    dist = torch.sqrt((acx[None, :, None] - gcx[:, None, :]) ** 2
                      + (acy[None, :, None] - gcy[:, None, :]) ** 2)
    cands, start = [], 0
    for n in num_anchors_per_level:
        lvl = dist[:, start:start + n]                          # (B, n, K)
        kth = torch.topk(lvl, min(topk, n), dim=1, largest=False).values[:, -1]
        cands.append(lvl <= kth[:, None, :])
        start += n
    cand = torch.cat(cands, dim=1)
    count = cand.sum(dim=1).to(ious.dtype)                      # (B, K)
    mean = torch.where(cand, ious, zero).sum(dim=1) / count
    var = torch.where(cand, (ious - mean[:, None, :]) ** 2, zero).sum(dim=1) \
        / count
    thr = mean + torch.sqrt(var)
    inside = ((acx[None, :, None] > gt_bboxes[:, None, :, 0])
              & (acx[None, :, None] < gt_bboxes[:, None, :, 2])
              & (acy[None, :, None] > gt_bboxes[:, None, :, 1])
              & (acy[None, :, None] < gt_bboxes[:, None, :, 3]))
    pos_mask = cand & (ious >= thr[:, None, :]) & inside & gt_valid[:, None, :]
    pos_ious = torch.where(pos_mask, ious, gt_bboxes.new_full((), -1.0))
    max_iou = pos_ious.amax(dim=-1)
    argmax = pos_ious.argmax(dim=-1)        # the first maximum, as jnp.argmax
    is_pos = max_iou > 0
    labels = torch.where(is_pos, torch.gather(gt_labels.to(torch.int64), 1,
                                              argmax),
                         torch.full_like(argmax, num_classes))
    assigned = torch.where(is_pos, argmax, torch.full_like(argmax, -1))
    return (labels, assigned, torch.ones(labels.shape, device=labels.device),
            torch.where(is_pos, max_iou, ious.amax(dim=-1)))
