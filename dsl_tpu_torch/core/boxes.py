"""Box math on the FCOS predict path, in torch.

Counterpart of ``dsl_tpu/core/boxes.py``: boxes are ``(x1, y1, x2, y2)``,
corner-exclusive (area = (x2-x1)*(y2-y1)), and every function is
shape-polymorphic over leading dimensions.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) boxes."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  eps: float = EPS) -> torch.Tensor:
    """Pairwise IoU: (..., M, 4) x (..., N, 4) -> (..., M, N)."""
    area1 = bbox_area(boxes1)
    area2 = bbox_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    overlap = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / union.clamp_min(eps)


def clip_boxes(boxes: torch.Tensor, max_shape: tuple[int, int]) -> torch.Tensor:
    """Clip boxes to an image of (H, W)."""
    h, w = max_shape[0], max_shape[1]
    x1 = boxes[..., 0].clamp(0, w)
    y1 = boxes[..., 1].clamp(0, h)
    x2 = boxes[..., 2].clamp(0, w)
    y2 = boxes[..., 3].clamp(0, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2bbox(points: torch.Tensor, distances: torch.Tensor,
                  max_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """Decode (l, t, r, b) distances at (x, y) points into boxes."""
    x1 = points[..., 0] - distances[..., 0]
    y1 = points[..., 1] - distances[..., 1]
    x2 = points[..., 0] + distances[..., 2]
    y2 = points[..., 1] + distances[..., 3]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    if max_shape is not None:
        boxes = clip_boxes(boxes, max_shape)
    return boxes
