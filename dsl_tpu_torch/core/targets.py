"""FCOS dense target assignment, batched with no loop over images.

Counterpart of ``dsl_tpu/core/targets.py``. Ground truth comes K-padded:
``(B, K, 4)`` boxes, ``(B, K)`` labels and a ``(B, K)`` validity mask. Every
point is tested against every box at once, ``(B, P, K)``; a box that does not
claim a point (padding, outside it or its centre region, outside the level's
regress range) has its area set to ``INF``, and the point takes the box of
least area, the first one at a tie. Foreground classes are ``[0,
num_classes)``; the background label is ``num_classes``.

Targets depend only on the batch: the caller computes them under
``torch.no_grad()``, so the ``(B, P, K, 4)`` temporaries are not kept for
the backward pass.
"""

from __future__ import annotations

import torch

INF = 1e8


def centerness_target(bbox_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min_lr / max_lr) * (min_tb / max_tb)) per (l, t, r, b) row; 0 on
    rows that are not positive, so it can be computed densely."""
    lr = bbox_targets[..., 0::2]
    tb = bbox_targets[..., 1::2]
    tiny = bbox_targets.new_full((), 1e-12)
    val = ((lr.amin(-1) / torch.maximum(lr.amax(-1), tiny))
           * (tb.amin(-1) / torch.maximum(tb.amax(-1), tiny)))
    return torch.sqrt(torch.maximum(val, val.new_zeros(())))


def fcos_targets(points: torch.Tensor, regress_ranges: torch.Tensor,
                 strides: torch.Tensor, gt_bboxes: torch.Tensor,
                 gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                 num_classes: int = 80, center_sampling: bool = True,
                 center_sample_radius: float = 1.5,
                 norm_on_bbox: bool = True):
    """Batched FCOS assignment.

    points (P, 2) xy of all levels in level order, regress_ranges (P, 2),
    strides (P,); gt_bboxes (B, K, 4), gt_labels (B, K), gt_valid (B, K).
    Returns labels (B, P) int64 (``num_classes`` = background) and
    bbox_targets (B, P, 4) as (l, t, r, b), divided by the point's stride
    when ``norm_on_bbox``.
    """
    xs = points[None, :, None, 0]                          # (1, P, 1)
    ys = points[None, :, None, 1]
    gx1, gy1 = gt_bboxes[:, None, :, 0], gt_bboxes[:, None, :, 1]   # (B, 1, K)
    gx2, gy2 = gt_bboxes[:, None, :, 2], gt_bboxes[:, None, :, 3]
    bbox_targets = torch.stack([xs - gx1, ys - gy1, gx2 - xs, gy2 - ys],
                               dim=-1)                     # (B, P, K, 4)
    if center_sampling:
        radius = strides[None, :, None] * center_sample_radius
        cx = (gx1 + gx2) * 0.5
        cy = (gy1 + gy2) * 0.5
        cx1 = torch.maximum(cx - radius, gx1)
        cy1 = torch.maximum(cy - radius, gy1)
        cx2 = torch.minimum(cx + radius, gx2)
        cy2 = torch.minimum(cy + radius, gy2)
        inside_gt = torch.stack([xs - cx1, ys - cy1, cx2 - xs, cy2 - ys],
                                dim=-1).amin(-1) > 0
    else:
        inside_gt = bbox_targets.amin(-1) > 0
    max_dist = bbox_targets.amax(-1)                       # (B, P, K)
    inside_range = ((max_dist >= regress_ranges[None, :, None, 0])
                    & (max_dist <= regress_ranges[None, :, None, 1]))
    areas = ((gx2 - gx1) * (gy2 - gy1)).expand_as(max_dist)
    areas = torch.where(inside_gt & inside_range & gt_valid[:, None, :],
                        areas, areas.new_full((), INF))
    min_area, min_idx = areas.min(dim=2)                   # first index at ties
    labels = torch.where(min_area < INF, gt_labels.long().gather(1, min_idx),
                         num_classes)
    tgt = bbox_targets.gather(
        2, min_idx[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]
    if norm_on_bbox:
        tgt = tgt / strides[None, :, None]
    return labels, tgt


def expand_point_metadata(featmap_sizes: list[tuple[int, int]],
                          strides: list[int],
                          regress_ranges: list[tuple[float, float]],
                          device: torch.device | str = "cpu"):
    """The per-point (P,) stride and (P, 2) regress range of the levels, in
    level order, as f32 tensors made on ``device`` (fills, not a copy from
    the host, which would wait for the card inside a train step)."""
    def full(n, v):
        return torch.full((n,), float(v), dtype=torch.float32, device=device)

    counts = [h * w for h, w in featmap_sizes]
    stride = torch.cat([full(n, s) for n, s in zip(counts, strides)])
    ranges = torch.cat([torch.stack([full(n, lo), full(n, hi)], dim=-1)
                        for n, (lo, hi) in zip(counts, regress_ranges)])
    return stride, ranges


def ignore_weight(labels: torch.Tensor, ignore_labels: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """DSL's ignore-region classification weight: 0 where a point is
    assigned to an ignore box and to no real box, else 1."""
    ignored = (ignore_labels != num_classes) & (labels == num_classes)
    return torch.where(ignored, 0.0, 1.0)
