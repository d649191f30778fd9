"""Hard NMS family with static output sizes and an explicit batch dimension.

Counterpart of ``dsl_tpu/core/nms.py`` (``nms``, ``batched_nms``,
``multiclass_nms``, ``fast_nms``), where the JAX package vmaps over images: here every
function takes (B, ...) inputs and calls :func:`nms_keep` once for the whole
batch. JAX's ``argsort`` is stable and ``lax.top_k`` breaks ties toward the
lower index; ``torch.topk`` promises no tie order, so every ranking here is
``torch.sort(..., descending=True, stable=True)`` and a slice.
"""

from __future__ import annotations

import torch

from dsl_tpu_torch.core.boxes import bbox_overlaps
from dsl_tpu_torch.ops.nms import nms_keep

NEG_INF = -1e30


def _sort_desc(x: torch.Tensor, k: int | None = None):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    if k is not None:
        vals, idx = vals[..., :k], idx[..., :k]
    return vals, idx


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, K) along dim 1."""
    flat = idx.reshape(*idx.shape, *(1,) * (x.dim() - 2))
    return torch.take_along_dim(x, flat, dim=1)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_out: int = 100, valid: torch.Tensor | None = None):
    """Hard NMS per image with ``max_out`` output slots.

    boxes (B, N, 4), scores (B, N), valid optional (B, N) bool.
    Returns dets (B, max_out, 5) [x1, y1, x2, y2, score] with padded rows at
    score NEG_INF and zero boxes, idx (B, max_out) into the input (0 where
    padded), out_valid (B, max_out) bool.
    """
    bsz, n = scores.shape
    if valid is None:
        valid = torch.ones((bsz, n), dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    scores_s, order = _sort_desc(masked)
    boxes_s = _gather_rows(boxes, order).contiguous()
    valid_s = torch.gather(valid, 1, order).contiguous()

    keep = nms_keep(boxes_s, valid_s, iou_threshold)

    kept = torch.where(keep, scores_s, torch.full_like(scores_s, NEG_INF))
    # scores_s is descending, so the top of `kept` stays in score order
    k = min(max_out, n)
    top_scores, top_pos = _sort_desc(kept, k)
    if k < max_out:
        pad = max_out - k
        top_scores = torch.cat(
            [top_scores, top_scores.new_full((bsz, pad), NEG_INF)], dim=1)
        top_pos = torch.cat([top_pos, top_pos.new_zeros((bsz, pad))], dim=1)
    out_valid = top_scores > NEG_INF / 2
    out_boxes = torch.where(out_valid[..., None], _gather_rows(boxes_s, top_pos),
                            torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    dets = torch.cat([out_boxes, top_scores[..., None]], dim=-1)
    idx = torch.where(out_valid, torch.gather(order, 1, top_pos),
                      torch.zeros_like(top_pos))
    return dets, idx, out_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                labels: torch.Tensor, iou_threshold: float = 0.5,
                max_out: int = 100, valid: torch.Tensor | None = None):
    """Class-aware NMS by the class-offset trick: each class's boxes are
    shifted by ``label * max_coord`` so different classes never overlap.
    ``max_coord`` is taken per image, as the JAX package's vmap does.

    Returns (dets, idx, out_valid) as :func:`nms`, plus out_labels.
    """
    bsz, n = scores.shape
    if valid is None:
        valid = torch.ones((bsz, n), dtype=torch.bool, device=scores.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(1, 2)) + 1.0
    offsets = labels.to(boxes.dtype)[..., None] * max_coord[:, None, None]
    dets, idx, out_valid = nms(boxes + offsets, scores, iou_threshold, max_out,
                               valid)
    out_boxes = torch.where(out_valid[..., None], _gather_rows(boxes, idx), zero)
    out_dets = torch.cat([out_boxes, dets[..., 4:5]], dim=-1)
    out_labels = torch.where(out_valid, torch.gather(labels, 1, idx),
                             torch.zeros_like(idx))
    return out_dets, idx, out_valid, out_labels


def multiclass_nms(multi_bboxes: torch.Tensor, multi_scores: torch.Tensor,
                   score_thr: float = 0.05, iou_threshold: float = 0.5,
                   max_per_img: int = 100, pre_nms_top: int = 2000,
                   valid: torch.Tensor | None = None, nms_type: str = "nms",
                   score_factors: torch.Tensor | None = None):
    """Multi-class NMS over per-point class scores, static shapes throughout.

    Every (point, class) pair whose RAW score exceeds ``score_thr`` is a
    candidate; ``score_factors`` (centerness) multiply after the threshold;
    the ``pre_nms_top`` best candidates go through class-offset NMS and the
    top ``max_per_img`` survive.

    multi_bboxes (B, P, 4) class-agnostic boxes or (B, P, C, 4) per-class
    boxes (the RoI head's), multi_scores (B, P, C), valid optional (B, P),
    score_factors optional (B, P).
    Returns dets (B, max_per_img, 5), labels (B, max_per_img), out_valid.
    """
    if nms_type != "nms":
        raise NotImplementedError(
            f"nms_type={nms_type!r}: only hard NMS is ported so far")
    bsz, p, c = multi_scores.shape
    if valid is None:
        valid = torch.ones((bsz, p), dtype=torch.bool, device=multi_scores.device)
    cand = valid[..., None] & (multi_scores > score_thr)
    if score_factors is not None:
        multi_scores = multi_scores * score_factors[..., None]
    flat = torch.where(cand, multi_scores,
                       torch.full_like(multi_scores, NEG_INF)).reshape(bsz, -1)
    top_scores, flat_idx = _sort_desc(flat, min(pre_nms_top, p * c))
    point_idx = flat_idx // c
    cls_idx = flat_idx % c
    if multi_bboxes.dim() == 4:
        cand_boxes = _gather_rows(multi_bboxes.reshape(bsz, p * c, 4), flat_idx)
    else:
        cand_boxes = _gather_rows(multi_bboxes, point_idx)
    cand_valid = top_scores > NEG_INF / 2
    dets, _, out_valid, out_labels = batched_nms(
        cand_boxes, top_scores, cls_idx, iou_threshold, max_per_img, cand_valid)
    return dets, out_labels, out_valid


def soft_nms(*args, **kwargs):
    raise NotImplementedError("soft_nms is not ported yet")


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor,
             score_thr: float = 0.05, iou_threshold: float = 0.5,
             top_k: int = 200, max_num: int = 100):
    """YOLACT's fast NMS over a batch: per image and class, the ``top_k``
    best boxes; a box is kept when its IoU with every higher-scored box of
    its class (kept or not) is at most ``iou_threshold`` and its score
    passes ``score_thr``; then the ``max_num`` best kept (class, box)
    pairs. One (C, K, K) IoU per image, no NMS kernel (the JAX package's is
    plain XLA too).

    boxes (B, N, 4) shared by the classes, scores (B, N, C) (no background
    column). Returns dets (B, M, 5), labels (B, M), box_idx (B, M) (the
    row of ``boxes`` each slot reads: for an invalid slot the one JAX's
    ``top_k`` order gives, whose coefficients fill YOLACT's empty crops),
    valid (B, M), M = min(max_num, C * K)."""
    b, n, c = scores.shape
    k = min(top_k, n)
    top_s, idx = _sort_desc(scores.transpose(1, 2), k)        # (B, C, K)
    bx = _gather_rows(boxes, idx.reshape(b, c * k)).reshape(b, c, k, 4)
    iou = torch.triu(bbox_overlaps(bx, bx), diagonal=1)        # (B, C, K, K)
    keep = (iou.amax(dim=2) <= iou_threshold) & (top_s > score_thr)
    flat = torch.where(keep, top_s, torch.full_like(top_s, NEG_INF)
                       ).reshape(b, -1)
    out_s, out_i = _sort_desc(flat, min(max_num, c * k))
    box_idx = torch.gather(idx.reshape(b, -1), 1, out_i)
    valid = out_s > NEG_INF / 2
    dets = torch.cat([_gather_rows(boxes, box_idx) * valid[..., None],
                      torch.where(valid, out_s, out_s.new_zeros(()))[..., None]],
                     dim=-1)
    labels = torch.where(valid, out_i // k, torch.zeros_like(out_i))
    return dets, labels, box_idx, valid
