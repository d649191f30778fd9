"""Box math of the FCOS predict and train paths, in torch.

Counterpart of ``dsl_tpu/core/boxes.py``: boxes are ``(x1, y1, x2, y2)``,
corner-exclusive (area = (x2-x1)*(y2-y1)), and every function is
shape-polymorphic over leading dimensions.
"""

from __future__ import annotations

import torch

EPS = 1e-6


def _floor(x: torch.Tensor, value: float) -> torch.Tensor:
    """max(x, value) as ``jnp.maximum`` computes it: at a tie the gradient
    splits 0.5/0.5, where ``clamp_min`` passes all of it (boxes with integer
    corners touch exactly). The constant is made on x's device, no copy."""
    return torch.maximum(x, x.new_full((), value))


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) boxes."""
    w = _floor(boxes[..., 2] - boxes[..., 0], 0.0)
    h = _floor(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  mode: str = "iou", is_aligned: bool = False,
                  eps: float = EPS) -> torch.Tensor:
    """IoU or GIoU, pairwise (..., M, 4) x (..., N, 4) -> (..., M, N), or
    aligned (..., M, 4) x (..., M, 4) -> (..., M)."""
    if mode not in ("iou", "giou"):
        raise ValueError(f"bbox_overlaps mode {mode!r}: 'iou' or 'giou'")
    area1 = bbox_area(boxes1)
    area2 = bbox_area(boxes2)
    if not is_aligned:
        boxes1, boxes2 = boxes1[..., :, None, :], boxes2[..., None, :, :]
        area1, area2 = area1[..., :, None], area2[..., None, :]
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = _floor(rb - lt, 0.0)
    overlap = wh[..., 0] * wh[..., 1]
    union = _floor(area1 + area2 - overlap, eps)
    ious = overlap / union
    if mode == "iou":
        return ious
    enc_lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    enc_rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    enc_wh = _floor(enc_rb - enc_lt, 0.0)
    enc_area = _floor(enc_wh[..., 0] * enc_wh[..., 1], eps)
    return ious - (enc_area - union) / enc_area


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


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor,
                  max_dis: float | None = None, eps: float = 0.1) -> torch.Tensor:
    """Encode boxes as (l, t, r, b) distances from (x, y) points."""
    d = torch.stack([points[..., 0] - bbox[..., 0],
                     points[..., 1] - bbox[..., 1],
                     bbox[..., 2] - points[..., 0],
                     bbox[..., 3] - points[..., 1]], dim=-1)
    if max_dis is not None:
        d = d.clamp(0, max_dis - eps)
    return d
